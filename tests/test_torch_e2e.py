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


@pytest.mark.parametrize("flags,fields", [
    (["-exchange", "xdir"], {"build_exchange_dir": "xdir"}),
    (["-exchange", "xdir", "-shards", "4"],
     {"build_exchange_dir": "xdir", "index_shards": 4}),
    (["-trace", "tr", "-l", "48"], {"trace": "tr", "seedl": 48}),
    (["-trace", "tr"], {"trace": "tr"}),
    (["-metrics", "m.json"], {"metrics_json": "m.json"}),
    (["-metrics", "m.json", "-debug", "1", "-ckpt", "c.ckpt"],
     {"metrics_json": "m.json", "debug_checks": True,
      "checkpoint": "c.ckpt"})])
def test_cli_flags_this_slice_lacks_raise(flags, fields):
    """-trace, -metrics and -exchange parse into their fields, alone or
    beside other flags, and the parse raises nothing."""
    cfg = t_main.parse_args(["-t", "g.fa", "-p", "r.fa", "-o", "o.txt",
                             *flags])
    assert {k: getattr(cfg, k) for k in fields} == fields
    unset = {"trace", "metrics_json", "build_exchange_dir"} - set(fields)
    assert all(getattr(cfg, k) == "" for k in unset)


def _two_text_dir(tmp_path, genome):
    """A directory of two .fa files holding the genome's fragments."""
    d = tmp_path / "texts"
    d.mkdir()
    records = open(genome).read().split(">")[1:]
    half = len(records) // 2
    for name, part in (("a.fa", records[:half]), ("b.fa", records[half:])):
        (d / name).write_text("".join(">" + r for r in part))
    return str(d)


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_two_text_directory_equals_real_tpu(tmp_path, unique):
    """-t <directory> with two .fa files: fileid 1 and the file transition
    of the unit loop, in both modes, against real_tpu's records."""
    genome, reads = ab_util.make_inputs(tmp_path, n=24000, numpat=240,
                                        patlen=80, seed=17, num_fragments=4)
    textdir = _two_text_dir(tmp_path, genome)
    out = tmp_path / "out.txt"
    assert t_main.main(["-device", "cpu", "-t", textdir, "-p", reads,
                        "-o", str(out), "-B", "512", "-R", "0",
                        "-u", str(int(unique))]) == 0
    ours = out.read_text()
    assert ours == ab_util.run_ours(textdir, reads, unique=unique,
                                    use_mesh=False)
    # records name fragments of both files
    assert len({line.split("\t")[7] for line in ours.splitlines()}) == 4


@pytest.mark.parametrize("flags,field,value", [
    (["-shards", "4"], "index_shards", 4), (["-l", "48"], "seedl", 48),
    (["-l", "64"], "seedl", 64), (["-ckpt", "c.ckpt"], "checkpoint", "c.ckpt"),
    (["-ckpt_every", "3"], "checkpoint_every", 3),
    (["-watchdog", "0"], "watchdog_s", 0), (["-debug", "1"], "debug_checks",
                                            True),
    (["-f", "0.5"], "fracmem", 0.5)])
def test_cli_flags_of_this_slice_reach_the_config(flags, field, value):
    cfg = t_main.parse_args(["-t", "g.fa", "-p", "r.fa", "-o", "o.txt",
                             *flags])
    assert getattr(cfg, field) == value


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_cli_native_off_writes_the_same_file(tmp_path, fastq):
    """-native 0 (every host phase through its plain NumPy version) and the
    default (the C++ library) print the same bytes, and both equal
    real_tpu's."""
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=200,
                                        seed=15, fastq=fastq,
                                        num_fragments=3)
    outs = []
    for flags in ([], ["-native", "0"]):
        out = tmp_path / f"out{len(outs)}.txt"
        assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                            "-o", str(out), "-B", "512", "-R", "0",
                            *flags]) == 0
        outs.append(out.read_bytes())
    assert outs[0].count(b"\n") > 150
    assert outs[0] == outs[1]
    assert outs[0].decode("latin-1") == ab_util.run_ours(genome, reads,
                                                         use_mesh=False)


def test_native_flag_reaches_the_config():
    base = ["-t", "g.fa", "-p", "r.fa", "-o", "o.txt"]
    assert t_main.parse_args(base).native_host is True
    assert t_main.parse_args(base + ["-native", "0"]).native_host is False
    assert t_main.parse_args(base + ["-R", "0"]).rewritepatterns is False
