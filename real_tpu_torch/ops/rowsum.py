"""Row-gather-sum: the wrapping 32-bit sum of W consecutive words at N
start offsets.

Counterpart of the TPU kernel benchmarks/pallasbench.py:pal_rowdma, the
row-DMA gather of the gather micro-benchmark with each lane's W words
summed to one int32. Its only caller is that benchmark's port,
real_tpu_torch/tools/gatherbench.py. The edge rules are the window
gather's (ops/gather.py): the start is clamped to [0, mw-1] and words past
the table end count as 0. On pal_rowdma's own domain (0 <= idx < mw-256,
w <= 128) neither rule applies and the two agree lane for lane.

On a CUDA tensor the wrapper launches the hand-written kernel
csrc/gather_rowsum.cu or raises; the plain PyTorch version serves CPU
tensors only. The kernel's design (its header has the reasons): w is a
template parameter for w in 1, 2, 3, 4, 8, 16, a thread serves two lanes
one grid apart, and for w >= 4 a window is fetched with 16 B aligned uint4
loads and masked in registers; other widths, and a table whose base is not
16 B aligned, take a run-time instance with scalar loads. What bounds it is
not bytes at the streaming rate (3.2 us at the micro-benchmark's shape)
but the launch floor plus the card's rate for scattered 32 B sectors: on an
NVIDIA H100 80GB HBM3 at 700 W one table word per lane already costs 4.5 us
of the ~6.9 us the whole window takes (tools/gathertune.py, rowsum sweep;
PERF.md).
"""

from __future__ import annotations

import ctypes

import torch

from real_tpu_torch.ops import cuda_build
from real_tpu_torch.text.packed import MASK32, i32_bits, u32

KERNEL = "gather_rowsum"


def gather_rowsum_ref(words: torch.Tensor, idx: torch.Tensor,
                      w: int) -> torch.Tensor:
    """Plain version: pad the table with w zeros, clamp the start to
    [0, mw-1], sum w lookups in int64, keep the low 32 bits and return
    them as int32 bit patterns shaped like idx."""
    mw = words.shape[0]
    padded = torch.cat([words, words.new_zeros(w)])
    p = idx.to(torch.int64).clamp(0, mw - 1)
    total = torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    for k in range(w):
        total += u32(padded[p + k])
    return i32_bits(total & MASK32)


_fn = None


def _kernel():
    """The C entry point gather_rowsum_i32, built and bound on first use."""
    global _fn
    if _fn is None:
        fn = cuda_build.load(KERNEL).gather_rowsum_i32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather_rowsum(words: torch.Tensor, idx: torch.Tensor,
                  w: int) -> torch.Tensor:
    """sum_k words[clamp(idx, 0, mw-1) + k] mod 2^32 for k < w, zero past
    the table end, as int32 bit patterns shaped like idx.

    `words` is a 1-D int32 table (32-bit bit patterns); `idx` int32 start
    offsets of any shape. CPU tensors take gather_rowsum_ref; CUDA tensors
    launch the kernel, and anything else raises."""
    if words.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rowsum_ref(words, idx, w)
    if words.device.type != "cuda" or idx.device != words.device:
        raise ValueError(
            f"gather_rowsum: words on {words.device}, idx on {idx.device}; "
            "both must be on one CUDA device (or the CPU)")
    if words.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("gather_rowsum: the kernel takes int32 words and "
                        f"int32 idx, got {words.dtype} and {idx.dtype}")
    if words.dim() != 1 or not words.is_contiguous() or words.numel() < 1:
        raise ValueError("gather_rowsum: words must be a non-empty "
                         "contiguous 1-D table")
    if w < 1:
        raise ValueError(f"gather_rowsum: w={w} must be >= 1")
    flat = idx.contiguous().reshape(-1)
    n = flat.numel()
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    if n:
        with torch.cuda.device(words.device):
            rc = _kernel()(
                words.data_ptr(), words.numel(), flat.data_ptr(), n, w,
                out.data_ptr(),
                torch.cuda.current_stream(words.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gather_rowsum launch failed: CUDA error {rc}")
        gather_rowsum.launches += 1
    return out.view(idx.shape)


# kernel launches since the last reset (chip_smoke.py proves the
# micro-benchmark went through the kernel with it)
gather_rowsum.launches = 0


def reset_launch_counts() -> None:
    gather_rowsum.launches = 0
