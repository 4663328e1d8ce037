// Window gather for Hopper (sm_90a): for each start offset idx[i], the w
// consecutive 32-bit words words[p + k], k < w, p = clamp(idx[i], 0, mw-1);
// words past the table end read 0.
//
// Replaces the TPU kernel real_tpu/ops/pallas_gather.py:_window_call (the
// row-DMA Pallas gather behind gather_word_windows). The TPU kernel stages
// two 512 B table rows per lane through SMEM/VMEM with DMA semaphores only
// because Mosaic offered no vector gather; a GPU thread can load any
// address, so none of that structure is carried over: one thread handles
// one lane, loads its start index, clamps it, and reads its w contiguous
// words through the read-only cache (__ldg).
//
// Element type: int32 only. The port stores every table this kernel reads
// (packed text words, bucket tables, signature lists) as int32 holding
// real_tpu's uint32 bit patterns, and no table it reads is 8 bytes wide.
//
// Output layout [w, n]: word k of lane i goes to out[k * n + i], so for
// every k a warp's 32 stores are one coalesced 128 B transaction. The
// loads are not coalesced across lanes (random starts), but a lane's w
// words are contiguous, so one lane touches 1-2 32 B sectors.
//
// What bounds it: bytes. Per call it moves n * (4 + 4w) B of index and
// output plus about n * 32 B of gathered sectors (one or two 32 B sectors
// per lane). At the main path's shapes (n = 16K..98K lanes, w = 2..8) that
// is well under 4 MB, a few microseconds at 3.35 TB/s, so the kernel is
// latency- and launch-bound: one load round trip for the index, one for
// the words. The design keeps it to those two dependent round trips (the
// w loads of a lane are independent and issue back to back) and launches
// enough 256-thread blocks to cover every lane at once. Fusing the
// funnel shift of the caller (engine/matchstep.py _extract_windows) to
// save the output round trip is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_windows_kernel(const int32_t* __restrict__ words,
                                      int64_t mw,
                                      const int32_t* __restrict__ idx,
                                      int64_t n, int w,
                                      int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  int64_t p = __ldg(idx + i);
  p = p < 0 ? 0 : (p > mw - 1 ? mw - 1 : p);
  for (int k = 0; k < w; ++k) {
    const int64_t q = p + k;
    out[static_cast<int64_t>(k) * n + i] = q < mw ? __ldg(words + q) : 0;
  }
}

}  // namespace

// words: int32 [mw] (mw >= 1); idx: int32 [n]; out: int32 [w, n].
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gather_windows_i32(const void* words, int64_t mw,
                                  const void* idx, int64_t n, int w,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  gather_windows_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), mw,
      static_cast<const int32_t*>(idx), n, w, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
