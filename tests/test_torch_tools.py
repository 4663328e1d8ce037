"""The port's helper tools (real_tpu_torch/tools/cli.py) print what
real_tpu's print for the same arguments, byte for byte."""

import shutil

import pytest

from real_tpu.tools import cli as j_cli
from real_tpu_torch.scoring.scoring import Scoring
from real_tpu_torch.tools import cli as t_cli


def _stdout(capsys, fn, args):
    assert fn(args) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("args", [["5000"], ["3000", "7"]],
                         ids=["default_seed", "seed7"])
def test_randstr_equals_real_tpus(capsys, args):
    ours = _stdout(capsys, t_cli.randstr_main, args)
    assert ours.startswith(f">random_{args[0]}")
    assert ours == _stdout(capsys, j_cli.randstr_main, args)


@pytest.mark.parametrize("fastq", ["0", "1"], ids=["fasta", "fastq"])
def test_genpat_equals_real_tpus(capsys, tmp_path, fastq):
    genome = tmp_path / "g.fa"
    genome.write_text(_stdout(capsys, t_cli.randstr_main, ["4000", "3"]))
    args = [str(genome), "40", "60", "0.03", fastq, "5"]
    ours = _stdout(capsys, t_cli.genpat_main, args)
    assert ours.count("\n") == 40 * (4 if fastq == "1" else 2)
    assert ours == _stdout(capsys, j_cli.genpat_main, args)


@pytest.mark.parametrize("fastq", ["0", "1"], ids=["fasta", "fastq"])
def test_reorder_equals_real_tpus(capsys, tmp_path, fastq):
    """Each package reads its own copy: both keep a read store next to
    the file."""
    genome = tmp_path / "g.fa"
    genome.write_text(_stdout(capsys, t_cli.randstr_main, ["4000", "9"]))
    reads = _stdout(capsys, t_cli.genpat_main,
                    [str(genome), "30", "50", "0.02", fastq])
    outs = []
    for tag, fn in (("port", t_cli.reorder_main),
                    ("real_tpu", j_cli.reorder_main)):
        d = tmp_path / tag
        d.mkdir()
        path = d / ("r.fq" if fastq == "1" else "r.fa")
        path.write_text(reads)
        outs.append(_stdout(capsys, fn, [str(path)]))
        # the second run loads the store the first wrote
        assert _stdout(capsys, fn, [str(path)]) == outs[-1]
        shutil.rmtree(d)
    assert outs[0].count("\n") == 30
    assert outs[0] == outs[1]


def test_print_scores_equals_real_tpus(capsys):
    ours = _stdout(capsys, t_cli.print_scores_main, [])
    assert ours.count("entry=") == 4 * 4 * 63
    assert ours == _stdout(capsys, j_cli.print_scores_main, [])


def test_raw_log_score_is_the_table_entry():
    from real_tpu.scoring.scoring import Scoring as JScoring
    ours, theirs = Scoring(), JScoring()
    for ref in range(4):
        for read in range(4):
            for q in (0, 1, 20, 40, 63):
                assert ours.raw_log_score(ref, read, q) \
                    == theirs.raw_log_score(ref, read, q)


@pytest.mark.parametrize("fn", [t_cli.randstr_main, t_cli.genpat_main,
                                t_cli.reorder_main],
                         ids=["randstr", "genpat", "reorder"])
def test_tools_without_arguments_print_their_usage(capsys, fn):
    assert fn([]) == 1
    assert "usage: real-tpu-torch-" in capsys.readouterr().err
