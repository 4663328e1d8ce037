"""Window gather: W consecutive 32-bit words at N start offsets.

Counterpart of real_tpu/ops/pallas_gather.py (gather_word_windows over the
Pallas kernel _window_call). It is the hot fetch of the match step at three
call sites (engine/matchstep.py): the kw+1 text words covering each
survivor window, the two adjacent bucket bounds of each probe, and the K1
tier-1 list signatures of each probe.

On a CUDA tensor the wrapper launches the hand-written kernel
csrc/gather_windows.cu (see its header for the design and what bounds it)
or raises; the plain PyTorch version serves CPU tensors only. Unlike
real_tpu, there is no size gate: the v5e-tuned thresholds of
use_pallas_gather do not apply to this card.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from real_tpu_torch.ops import cuda_build

KERNEL = "gather_windows"


def gather_word_windows_ref(words: torch.Tensor, idx: torch.Tensor,
                            w: int) -> List[torch.Tensor]:
    """Plain version: pad the table with w zeros, clamp the start to
    [0, mw-1], and stack w index lookups. Returns w tensors shaped like
    idx, of the table's dtype."""
    mw = words.shape[0]
    padded = torch.cat([words, words.new_zeros(w)])
    p = idx.to(torch.int64).clamp(0, mw - 1)
    return [padded[p + k] for k in range(w)]


_fn = None


def _kernel():
    """The C entry point gather_windows_i32, built and bound on first use."""
    global _fn
    if _fn is None:
        fn = cuda_build.load(KERNEL).gather_windows_i32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather_word_windows(words: torch.Tensor, idx: torch.Tensor,
                        w: int) -> List[torch.Tensor]:
    """words[clamp(idx, 0, mw-1) + k] for k in range(w), zero past the
    table end, as a list of w tensors shaped like idx — the same contract
    as real_tpu.ops.pallas_gather.gather_word_windows.

    `words` is a 1-D int32 table (32-bit bit patterns); `idx` int32 start
    offsets of any shape. CPU tensors take gather_word_windows_ref; CUDA
    tensors launch the kernel, and anything else raises."""
    if words.device.type == "cpu" and idx.device.type == "cpu":
        return gather_word_windows_ref(words, idx, w)
    if words.device.type != "cuda" or idx.device != words.device:
        raise ValueError(
            f"gather_word_windows: words on {words.device}, idx on "
            f"{idx.device}; both must be on one CUDA device (or the CPU)")
    if words.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("gather_word_windows: the kernel takes int32 words "
                        f"and int32 idx, got {words.dtype} and {idx.dtype}")
    if words.dim() != 1 or not words.is_contiguous() or words.numel() < 1:
        raise ValueError("gather_word_windows: words must be a non-empty "
                         "contiguous 1-D table")
    if w < 1:
        raise ValueError(f"gather_word_windows: w={w} must be >= 1")
    flat = idx.contiguous().reshape(-1)
    n = flat.numel()
    out = torch.empty((w, n), dtype=torch.int32, device=words.device)
    if n:
        with torch.cuda.device(words.device):
            rc = _kernel()(
                words.data_ptr(), words.numel(), flat.data_ptr(), n, w,
                out.data_ptr(),
                torch.cuda.current_stream(words.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gather_windows launch failed: CUDA error {rc}")
        gather_word_windows.launches += 1
        gather_word_windows.launches_by_w[w] = \
            gather_word_windows.launches_by_w.get(w, 0) + 1
    return list(out.view(w, *idx.shape).unbind(0))


# kernel launches since the last reset (chip_smoke.py proves the main path
# went through the kernel with these); launches_by_w splits them by window
# width, which tells the three call sites apart
gather_word_windows.launches = 0
gather_word_windows.launches_by_w = {}


def reset_launch_counts() -> None:
    gather_word_windows.launches = 0
    gather_word_windows.launches_by_w = {}
