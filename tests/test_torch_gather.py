"""The port's window gather (real_tpu_torch/ops/gather.py) against
real_tpu's Pallas kernel.

The plain version must equal the actual Pallas kernel run in TPU interpret
mode bit for bit, zero-past-end and clipped-start lanes included, and
jnp.take(mode="clip") on the lanes where the two contracts agree. All
comparisons are exact (integer bit patterns)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.ops import pallas_gather
from real_tpu_torch.ops import gather


def _table_and_idx(rng, mw, n):
    words = rng.integers(0, 2**32, mw, dtype=np.uint64).astype(np.uint32)
    words[:3] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]      # top-bit words
    idx = rng.integers(-40, mw + 40, n).astype(np.int32)
    idx[:8] = [-2**31, -1, 0, mw - 2, mw - 1, mw, mw + 7, 2**31 - 1]
    return words, idx


def _ref_np(words, idx, w):
    out = gather.gather_word_windows_ref(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(idx), w)
    return np.stack([o.numpy() for o in out], -1).view(np.uint32)


def test_ref_equals_pallas_kernel_interpret(monkeypatch):
    """One 16,384-lane slab of the Pallas kernel in TPU interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(0)
    mw, w = 3000, 8
    words, idx = _table_and_idx(rng, mw, pallas_gather.SLAB)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    pallas_gather._window_call.cache_clear()
    try:
        out = pallas_gather.gather_word_windows(
            jnp.asarray(words), jnp.asarray(idx), w)
        pal = np.stack([np.asarray(o) for o in out], -1)
    finally:
        pallas_gather._window_call.cache_clear()
    ref = _ref_np(words, idx, w)
    assert pal.dtype == np.uint32 and pal.shape == ref.shape
    np.testing.assert_array_equal(ref, pal)
    # the lanes that exercise the two edge rules are really there
    start = np.clip(idx, 0, mw - 1)
    assert ((start[:, None] + np.arange(w)) >= mw).any()
    assert (idx < 0).any() and (idx >= mw).any()
    assert (ref[(start + w - 1) >= mw, -1] == 0).all()


@pytest.mark.parametrize("w", [1, 2, 4, 8])
@pytest.mark.parametrize("mw", [5, 1000])
def test_ref_equals_take_clip_where_contracts_agree(w, mw):
    rng = np.random.default_rng(w * 1000 + mw)
    words, idx = _table_and_idx(rng, mw, 2048)
    ref = _ref_np(words, idx, w)
    start = np.clip(idx, 0, mw - 1)
    for k in range(w):
        take = np.asarray(jnp.take(jnp.asarray(words),
                                   jnp.asarray(start + k), mode="clip"))
        agree = start + k < mw
        np.testing.assert_array_equal(ref[agree, k], take[agree])
        assert (ref[~agree, k] == 0).all()


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(3)
    words, idx = _table_and_idx(rng, 777, 600)
    tw = torch.from_numpy(words.view(np.int32))
    ti = torch.from_numpy(idx).reshape(20, 30)
    before = gather.gather_word_windows.launches
    got = gather.gather_word_windows(tw, ti, 4)
    want = gather.gather_word_windows_ref(tw, ti, 4)
    assert gather.gather_word_windows.launches == before
    assert [g.shape for g in got] == [(20, 30)] * 4
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("words_dev,idx_dev", [("meta", "meta"),
                                               ("cpu", "meta"),
                                               ("meta", "cpu")])
def test_wrapper_never_sends_non_cpu_tensors_to_the_plain_version(
        words_dev, idx_dev):
    words = torch.zeros(16, dtype=torch.int32, device=words_dev)
    idx = torch.zeros(4, dtype=torch.int32, device=idx_dev)
    with pytest.raises(ValueError):
        gather.gather_word_windows(words, idx, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mw,w", [(5, 8), (3000, 8), (3000, 2), (3000, 4)])
def test_kernel_equals_plain_version_on_card(cuda_device, mw, w):
    rng = np.random.default_rng(mw + w)
    words, idx = _table_and_idx(rng, mw, 5000)
    tw = torch.from_numpy(words.view(np.int32)).to(cuda_device)
    ti = torch.from_numpy(idx).to(cuda_device).reshape(50, 100)
    before = gather.gather_word_windows.launches
    got = gather.gather_word_windows(tw, ti, w)
    torch.cuda.synchronize()
    assert gather.gather_word_windows.launches == before + 1
    for g, r in zip(got, gather.gather_word_windows_ref(tw, ti, w)):
        assert torch.equal(g, r)
