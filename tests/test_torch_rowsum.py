"""The port's row-gather-sum (real_tpu_torch/ops/rowsum.py) against
pallasbench's Pallas kernel pal_rowdma, numpy, and its own CUDA kernel.

The plain version summed to one uint32 must equal pal_rowdma run in TPU
interpret mode (benchmarks/pallasbench.py, loaded as a file and left
unedited), with top-bit words so that the lane sums wrap. Per lane it must
equal numpy, clamped starts and zero-past-end lanes included. All
comparisons are exact (integer bit patterns)."""

import functools
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu_torch.ops import rowsum
from real_tpu_torch.tools import gatherbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallasbench():
    spec = importlib.util.spec_from_file_location(
        "pallasbench", os.path.join(REPO, "benchmarks", "pallasbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(rng, mw):
    words = rng.integers(0, 2**32, mw, dtype=np.uint64).astype(np.uint32)
    top = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFE],
                   np.uint32)
    words[:4] = top[:min(mw, 4)]
    words[rng.integers(0, mw, mw // 4)] |= np.uint32(0x80000000)
    return words


def _np_rowsum(words, idx, w):
    """Per-lane numpy model of the contract (uint32 result)."""
    mw = len(words)
    p = np.clip(idx.astype(np.int64), 0, mw - 1)
    q = p[:, None] + np.arange(w)
    vals = np.where(q < mw, words[np.minimum(q, mw - 1)].astype(np.uint64),
                    0)
    return (vals.sum(axis=1) & 0xFFFFFFFF).astype(np.uint32)


def _ref_u32(words, idx, w):
    out = rowsum.gather_rowsum_ref(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(idx), w)
    assert out.dtype == torch.int32 and tuple(out.shape) == idx.shape
    return out.numpy().view(np.uint32)


def test_ref_equals_pal_rowdma_interpret(monkeypatch):
    """One 2,048-lane slab of pal_rowdma in TPU interpret mode; its uint32
    total equals the plain version's, numpy's and xla_take8's."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    pb = _pallasbench()
    rng = np.random.default_rng(0)
    mw, n, w = 5120, 2048, 8
    words = _table(rng, mw)
    idx = rng.integers(0, mw - 2 * pb.LANE, n).astype(np.int32)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    t2d = jnp.asarray(words.reshape(-1, pb.LANE))
    pal = int(pb.pal_rowdma(t2d, jnp.asarray(idx), w, slab=2048, ch=1024)())
    take8 = int(pb.xla_take8(t2d, jnp.asarray(idx), w)())
    lanes = _ref_u32(words, idx, w)
    # under x64 (tests/conftest.py) the final reduction of both JAX
    # variants accumulates the uint32 lane values in 64 bits
    total = int(lanes.astype(np.uint64).sum())
    assert pal == take8 == total
    np.testing.assert_array_equal(lanes, _np_rowsum(words, idx, w))
    # top-bit words really make lane sums wrap past 2^32
    wide = words[idx[:, None] + np.arange(w)].astype(np.uint64).sum(axis=1)
    assert (wide >= 2**32).any()


@pytest.mark.parametrize("w", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("mw", [1, 3, 7, 1000])
def test_ref_equals_numpy_with_edges(w, mw):
    """Lanes with idx < 0, idx >= mw, windows past the end and mw < w."""
    rng = np.random.default_rng(w * 1000 + mw)
    words = _table(rng, mw)
    idx = rng.integers(-40, mw + 40, 3000).astype(np.int32)
    idx[:8] = [-2**31, -1, 0, mw - 2, mw - 1, mw, mw + 7, 2**31 - 1]
    np.testing.assert_array_equal(_ref_u32(words, idx, w),
                                  _np_rowsum(words, idx, w))


# the widths of the kernel's template instances (1, 3, 8, 16) and one width
# that takes its run-time instance (5)
REDESIGN_WIDTHS = [1, 3, 5, 8, 16]


@pytest.mark.parametrize("w", REDESIGN_WIDTHS)
def test_redesign_widths_equal_pal_rowdma_interpret(monkeypatch, w):
    """The widths the redesigned kernel instantiates, on pal_rowdma's own
    domain (0 <= idx < mw - 256): uint32 totals of the plain version,
    pal_rowdma in TPU interpret mode, xla_take8 and numpy agree, with
    starts at every alignment modulo 4 and modulo 8."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    pb = _pallasbench()
    rng = np.random.default_rng(100 + w)
    mw, n = 5120, 2048
    words = _table(rng, mw)
    idx = rng.integers(0, mw - 2 * pb.LANE, n).astype(np.int32)
    idx[:16] = np.arange(16)                    # every start alignment
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    t2d = jnp.asarray(words.reshape(-1, pb.LANE))
    pal = int(pb.pal_rowdma(t2d, jnp.asarray(idx), w, slab=2048, ch=1024)())
    take8 = int(pb.xla_take8(t2d, jnp.asarray(idx), w)())
    lanes = _ref_u32(words, idx, w)
    assert pal == take8 == int(lanes.astype(np.uint64).sum())
    np.testing.assert_array_equal(lanes, _np_rowsum(words, idx, w))


@pytest.mark.parametrize("w", REDESIGN_WIDTHS)
@pytest.mark.parametrize("mw", [1001, 1002, 1003, 1004])
def test_ref_on_the_vector_load_edges(w, mw):
    """The cases the kernel's aligned 16 B loads must get right, held on
    the plain version against numpy: mw with every remainder modulo 4,
    windows that end exactly at mw, one word before and one past it, and
    starts at every offset inside an aligned group of four."""
    rng = np.random.default_rng(7 * mw + w)
    words = _table(rng, mw)
    idx = np.concatenate([
        [mw - w - 1, mw - w, mw - w + 1, mw - 5, mw - 4, mw - 3, mw - 2,
         mw - 1, mw, 0, 1, 2, 3, 4, 5, 6, 7],
        rng.integers(-8, mw + 8, 500)]).astype(np.int32)
    got = _ref_u32(words, idx, w)
    np.testing.assert_array_equal(got, _np_rowsum(words, idx, w))
    # a window that ends exactly at mw sums the table's last w words
    tail = int(words[mw - w:].astype(np.uint64).sum() & 0xFFFFFFFF)
    assert int(got[1]) == tail


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(3)
    words = torch.from_numpy(_table(rng, 777).view(np.int32))
    idx = torch.from_numpy(
        rng.integers(-5, 790, 600).astype(np.int32)).reshape(20, 30)
    before = rowsum.gather_rowsum.launches
    got = rowsum.gather_rowsum(words, idx, 4)
    assert rowsum.gather_rowsum.launches == before
    assert got.shape == (20, 30)
    assert torch.equal(got, rowsum.gather_rowsum_ref(words, idx, 4))


@pytest.mark.parametrize("words_dev,idx_dev", [("meta", "meta"),
                                               ("cpu", "meta"),
                                               ("meta", "cpu")])
def test_wrapper_never_sends_non_cpu_tensors_to_the_plain_version(
        words_dev, idx_dev):
    words = torch.zeros(16, dtype=torch.int32, device=words_dev)
    idx = torch.zeros(4, dtype=torch.int32, device=idx_dev)
    with pytest.raises(ValueError):
        rowsum.gather_rowsum(words, idx, 2)


def test_gatherbench_cpu_totals_agree(capsys):
    out = gatherbench.main(["--device", "cpu", "--m", "50000", "--n", "4096",
                            "--w", "8", "--reps", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert line["device"] == "cpu" and line["N"] == 4096
    assert line["take_sum_ok"] is True and line["rowsum_ok"] is True
    assert line["rowsum_ns"] > 0 and line["take_sum_ns"] > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mw,w", [(5, 8), (3000, 1), (3000, 8), (3000, 16),
                                  (1001, 3), (1002, 8), (1003, 5),
                                  (1003, 16)])
def test_kernel_equals_plain_version_on_card(cuda_device, mw, w):
    rng = np.random.default_rng(mw + w)
    words = torch.from_numpy(_table(rng, mw).view(np.int32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-40, mw + 40, 5000).astype(
        np.int32)).to(cuda_device).reshape(50, 100)
    before = rowsum.gather_rowsum.launches
    got = rowsum.gather_rowsum(words, idx, w)
    torch.cuda.synchronize()
    assert rowsum.gather_rowsum.launches == before + 1
    assert torch.equal(got, rowsum.gather_rowsum_ref(words, idx, w))
