"""The genome pack's CUDA kernel (real_tpu_torch/csrc/pack_text.cu through
ops/pack.py) against its plain version on the card: the crafted texts of
tools/packcases.py, a genome with Ns in chunks smaller than the text, and
one launch set a text. Skipped without a card; no JAX here."""

import numpy as np
import pytest
import torch

from real_tpu_torch.ops import pack
from real_tpu_torch.tools import packcases


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _check(codes, dev) -> None:
    before = pack.pack_text.launches
    got = pack.pack_text(codes, dev)
    torch.cuda.synchronize()
    assert pack.pack_text.launches == before + 1
    want = pack.pack_tables_ref(codes)
    for f, a, b in zip(want._fields, want, got):
        if isinstance(a, np.ndarray):
            assert b.device.type == "cuda" and b.dtype == torch.int32, f
            np.testing.assert_array_equal(a.view(np.int32), b.cpu().numpy(),
                                          err_msg=f)
        else:
            assert a == b, f


@pytest.mark.cuda
@pytest.mark.parametrize("case", packcases.crafted_texts(),
                         ids=lambda c: c.name)
def test_kernel_equals_plain_version_on_crafted_texts(cuda_device, case):
    _check(case.codes, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 96, 4096, pack.CHUNK_BASES])
def test_kernel_in_chunks_equals_plain_version(cuda_device, monkeypatch,
                                               chunk):
    rng = np.random.default_rng(chunk)
    codes = rng.choice(5, 100_003, p=[0.2, 0.2, 0.2, 0.35, 0.05]).astype(
        np.uint8)
    codes[5000:5100] = 3
    monkeypatch.setattr(pack, "CHUNK_BASES", chunk)
    _check(codes, cuda_device)
