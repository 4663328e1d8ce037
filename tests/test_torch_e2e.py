"""End to end: the port's matchUnique records are byte-identical to
real_tpu's single-device run (tests/ab_util.run_ours(..., use_mesh=False)),
through the driver and through the port's CLI. Exact (bytes)."""

import io

import pytest

from real_tpu.cli.output import write_unique as j_write_unique
from real_tpu.config import RealConfig as JConfig
from real_tpu.engine import driver as j_driver
from real_tpu.io import reads as j_reads
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.cli.output import write_unique
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.io import reads as reads_io
from tests import ab_util

CASES = {
    # make_inputs kwargs, scores, caps (cand_cap, survivor_cap) or None
    "scores_fasta": (dict(seed=7), True, None),
    "noscores_fasta": (dict(seed=0), False, None),
    "scores_fastq": (dict(seed=3, fastq=True), True, None),
    "n_in_genome": (dict(seed=5, n_prob=0.002, patlen=80), True, None),
    "multifragment": (dict(seed=9, n=30000, patlen=75, num_fragments=5),
                      True, None),
    "overflow_rerun": (dict(seed=11), True, (2, 2)),
}


def _real_tpu_records(genome, reads, scores, caps):
    if caps is None:
        return ab_util.run_ours(genome, reads, scores=scores,
                                use_mesh=False)
    # ab_util.run_ours with forced candidate caps (an overflow rerun)
    cfg = JConfig(textfilename=genome, patternfilename=reads,
                  outputfilename="-", scores=scores, index_shards=1,
                  batch_size=512, use_mesh=False, cand_cap=caps[0],
                  survivor_cap=caps[1])
    rs = j_reads.parse_reads(reads)
    texts = j_driver.load_texts(cfg)
    buf = io.StringIO()
    j_write_unique(buf, rs, j_driver.run_match_unique(cfg, rs, texts),
                   texts, scores)
    assert j_driver.last_metrics["overflow_rerun_reads"] > 0
    return buf.getvalue()


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_equal_real_tpu(tmp_path, case):
    kw, scores, caps = CASES[case]
    args = dict(n=20000, numpat=300, patlen=100, errprob=0.02)
    args.update(kw)
    genome, reads = ab_util.make_inputs(tmp_path, **args)
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", scores=scores, batch_size=512)
    if caps:
        cfg.cand_cap, cfg.survivor_cap = caps
    rs = reads_io.parse_reads(reads)
    texts = driver.load_texts(cfg, "cpu")
    result = driver.run_match_unique(cfg, rs, texts, "cpu")
    buf = io.StringIO()
    unique = write_unique(buf, rs, result, texts, scores)
    ours = buf.getvalue()
    assert unique > 200 and ours.count("\n") == unique
    assert ours == _real_tpu_records(genome, reads, scores, caps)
    if caps:
        assert result.metrics["overflow_rerun_reads"] > 0


def test_cli_writes_the_same_file(tmp_path):
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=200,
                                        seed=13)
    out = tmp_path / "out.txt"
    assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                        "-o", str(out), "-B", "512"]) == 0
    assert out.read_text() == ab_util.run_ours(genome, reads,
                                               use_mesh=False)


@pytest.mark.parametrize("flags", [["-u", "0"], ["-shards", "4"],
                                   ["-l", "48"], ["-ckpt", "c.ckpt"],
                                   ["-trace", "tr"], ["-metrics", "m.json"],
                                   ["-debug", "1"]])
def test_cli_flags_this_slice_lacks_raise(flags):
    with pytest.raises(NotImplementedError):
        t_main.parse_args(["-t", "g.fa", "-p", "r.fa", "-o", "o.txt",
                           *flags])
