// Row-gather-sum for Hopper (sm_90a): for each start offset idx[i], the
// wrapping 32-bit sum of the w consecutive words words[p + k], k < w,
// p = clamp(idx[i], 0, mw-1); words past the table end count as 0 (the
// edge rules of gather_windows.cu, so the two kernels share edge tests).
//
// Replaces the TPU kernel benchmarks/pallasbench.py:pal_rowdma, the gather
// micro-benchmark's kernel: per lane it DMAs the two 512 B table rows that
// cover the window into VMEM, waits on one byte-counting semaphore per
// 1024-lane chunk, extracts the w columns with take_along_axis and sums
// them to one int32. All of that exists because Mosaic had no vector
// gather; a GPU thread loads any address, so none of it is carried over:
// one thread per lane loads its index, clamps it, sums its w contiguous
// words through the read-only cache (__ldg) in a register, and writes one
// int32. A warp's 32 stores are one coalesced 128 B transaction.
//
// What bounds it: bytes. Per call it reads the n int32 indices, writes n
// int32 sums and touches one or two 32 B sectors of the table per lane:
// at the micro-benchmark's default (n = 262,144, w = 8, a 2.92M-word table)
// about 10 MB, 3 us at 3.35 TB/s. The table of that size sits in the 50 MB
// L2, so sectors come back at L2 latency; a 110 MB table misses L2 and each
// lane waits one HBM round trip. The design keeps each lane to two
// dependent round trips (index, then its w words, issued back to back) and
// covers every lane with 256-thread blocks at once, so the card has as
// many loads in flight as it can hold.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_rowsum_kernel(const uint32_t* __restrict__ words,
                                     int64_t mw,
                                     const int32_t* __restrict__ idx,
                                     int64_t n, int w,
                                     int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  int64_t p = __ldg(idx + i);
  p = p < 0 ? 0 : (p > mw - 1 ? mw - 1 : p);
  const int64_t end = p + w < mw ? p + w : mw;
  uint32_t acc = 0;                        // unsigned: wraps mod 2^32
  for (int64_t q = p; q < end; ++q) acc += __ldg(words + q);
  out[i] = static_cast<int32_t>(acc);
}

}  // namespace

// words: 32-bit [mw] (mw >= 1); idx: int32 [n]; out: int32 [n].
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gather_rowsum_i32(const void* words, int64_t mw,
                                 const void* idx, int64_t n, int w,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  gather_rowsum_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), mw,
      static_cast<const int32_t*>(idx), n, w, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
