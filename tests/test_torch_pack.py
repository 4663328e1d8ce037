"""The genome pack's wrapper (real_tpu_torch/ops/pack.py) on the CPU: its
plain version against real_tpu's host pack, on a genome with Ns, 3
fragments and planted all-T segment pairs and on the crafted texts of
tools/packcases.py, and the input the wrapper refuses. Exact: tables as
bit patterns, flags as values."""

import numpy as np
import pytest
import torch

from real_tpu.text import packed as j_packed
from real_tpu_torch.io import fasta as t_fasta
from real_tpu_torch.ops import pack
from real_tpu_torch.text import packed as t_packed
from real_tpu_torch.tools import packcases, simulate

TABLES = ("words", "nbits", "ncum", "nb16", "ncum16")
FLAGS = ("has_n", "allt32", "allt64")
# T runs (start, length) planted into the genome: none, a pair of 8-base
# segments 16 apart (the seedl 32 flag alone), and a pair of 16-base
# segments 48 apart (both flags: each 16-T run is an 8-base pair too)
PLANTED = {"none": ([], (False, False)),
           "seedl32": ([(2000, 8), (2016, 8)], (True, False)),
           "seedl64": ([(5003, 16), (5051, 16)], (True, True))}


def _equal_to_real_tpu(got, jt) -> None:
    for f in TABLES:
        a, b = getattr(jt, f), getattr(got, f)
        assert b.dtype == torch.int32 and b.device.type == "cpu", f
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      b.numpy().view(np.uint32), err_msg=f)
    for f in FLAGS:
        assert getattr(got, f) == bool(getattr(jt, f)), f


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    path = tmp_path_factory.mktemp("g") / "g.fa"
    path.write_text(simulate.random_genome(9000, seed=23, n_prob=0.01,
                                           num_fragments=3))
    return t_fasta.parse_genome(str(path))


@pytest.mark.parametrize("planted", sorted(PLANTED))
def test_cpu_route_is_the_plain_version_equal_to_real_tpu(genome, planted):
    codes, ranges = genome
    codes = codes.copy()
    # the genome's own T runs are cut first, so only the planted ones pair
    codes[codes == 3] = 0
    runs, (allt32, allt64) = PLANTED[planted]
    for start, length in runs:
        codes[start:start + length] = 3
    before = pack.pack_text.launches
    got = pack.pack_text(codes, "cpu")
    assert pack.pack_text.launches == before
    jt = j_packed.build_packed_text(codes, ranges)
    _equal_to_real_tpu(got, jt)
    assert (got.has_n, got.allt32, got.allt64) == (True, allt32, allt64)
    ref = pack.pack_tables_ref(codes)
    for f in TABLES:
        np.testing.assert_array_equal(
            getattr(ref, f).view(np.int32), getattr(got, f).numpy())
    text = t_packed.build_packed_text(codes, ranges, "cpu")
    assert pack.pack_text.launches == before
    for f in TABLES + FLAGS:
        assert (torch.equal(getattr(text, f), getattr(got, f))
                if f in TABLES else getattr(text, f) == getattr(got, f))
    assert text.num_fragments == 3 and text.n == len(codes)


@pytest.mark.parametrize("case", packcases.crafted_texts(),
                         ids=lambda c: c.name)
def test_crafted_texts_on_the_cpu_route(case):
    ranges = [("a", 0), ("terminal", len(case.codes))]
    jt = j_packed.build_packed_text(case.codes, ranges)
    got = pack.pack_text(case.codes, "cpu")
    _equal_to_real_tpu(got, jt)
    if case.flags is not None:
        assert (got.has_n, got.allt32, got.allt64) == case.flags


@pytest.mark.parametrize("codes,error", [
    (np.zeros(64, np.int64), TypeError),
    (np.zeros(64, np.int8), TypeError),
    (torch.zeros(64, dtype=torch.uint8), TypeError),
    (np.zeros(128, np.uint8)[::2], ValueError),
    (np.zeros((2, 32), np.uint8), ValueError),
], ids=["int64", "int8", "tensor", "strided", "2-d"])
def test_wrapper_refuses_codes_the_kernel_does_not_take(codes, error):
    with pytest.raises(error):
        pack.pack_text(codes, "cpu")


def test_wrapper_refuses_a_device_that_is_neither_cuda_nor_cpu():
    with pytest.raises(ValueError):
        pack.pack_text(np.zeros(40, np.uint8), "meta")


def test_pack_launches_are_in_the_one_launch_registry():
    from real_tpu_torch.ops import gather
    pack.pack_text.launches = 3
    assert gather.launch_counts()["pack_text"] == 3
    gather.reset_launch_counts()
    assert pack.pack_text.launches == 0
    pack.pack_text(np.zeros(100, np.uint8), "cpu")
    assert gather.launch_counts() == dict.fromkeys(gather.launch_counts(), 0)
