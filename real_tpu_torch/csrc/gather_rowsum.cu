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
// gather; a GPU thread loads any address, so none of it is carried over.
//
// What bounds it: the card's rate for scattered 32 B sectors, on top of a
// launch floor; not bytes at the streaming rate. At the micro-benchmark's
// shape (n = 262,144 lanes, w = 8) a call moves ~10 MB (indices in, sums
// out, one or two table sectors per lane): 3.2 us at 3.35 TB/s with the
// 11.7 MB table (it sits in the 50 MB L2), 5.0 us with a 110 MB table.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W by tools/gathertune.py
// (rowsum sweep; PERF.md lists every line): an empty kernel of the same
// grid takes 2.5-2.7 us per back-to-back launch, index load + store 2.8-2.9
// us, and one table word per lane 4.5 us (table in L2) / 5.2 us (110 MB
// table). That last figure is the floor of a scattered gather of this grid
// and is 64% of what the whole window costs, so the byte bound is out of
// reach and what is left to a design is about 2.5 us of sector traffic.
//
// The design kept, chosen by that sweep: w is a template parameter
// (instances for w = 1, 2, 3, 4, 8, 16; any other width, or a table whose
// base is not 16 B aligned, takes the run-time instance, which is the
// earlier design: one lane per thread, w scalar loads). A thread serves
// kRowsumLanes = 2 lanes one grid apart, so index loads and stores stay
// coalesced and both index loads start before the first table load.
// For w >= 4 a lane's window [p, p+w) is fetched with 16 B aligned uint4
// loads from p & ~3: ceil((w+3)/4) of them cover the window wherever it
// starts (three for w = 8; the last is skipped when the window does not
// reach it), the words outside [p, min(p+w, mw)) are masked in registers,
// and a vector that would cross the table end is fetched word by word with
// a bound check. A lane still has two dependent round trips (index, then
// window); the thread has up to six independent 16 B loads in flight.
// Measured against the earlier design (7.05-7.19 / 8.35-8.43 us over two
// sweeps): 6.80-6.92 / 8.02-8.26 us, 2-5% faster at both table sizes.
// What was weighed and lost, same sweeps: uint4 loads at one lane per
// thread (7.6 / 8.5 us: no faster than the scalar loads, whose seven
// repeats hit the L1 line the first one brought), the same uint4 loads
// past L1 (__ldcg: 1.2 us slower everywhere, the third vector of a window
// lives on L1 hits), four lanes
// per thread (6.7 us in L2 but 9.6-9.8 us past it: a quarter of the warps
// cannot keep enough sectors in flight), eight (8.8 / 15.4 us), a sub-warp
// layout of w threads per lane with a __shfl_xor_sync sum (7.7 / 12.4 us:
// eight times the threads, so eight waves of blocks), 64 to 1,024 threads
// per block (within 0.3 us), and an L2 access-policy window on the table
// (no change in L2, 10.9 us past it: the 31 MiB that may persist are taken
// from the rest). wgmma and TMA have no part here: there is no matrix
// product and no tile that two lanes share.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsumThreads = 256;
constexpr int kRowsumLanes = 2;          // lanes per thread (templated path)

__device__ __forceinline__ int64_t clamp_start(int32_t i, int64_t mw) {
  const int64_t p = i;
  return p < 0 ? 0 : (p > mw - 1 ? mw - 1 : p);
}

// Sum of words[p .. min(p+w, mw)) with scalar loads; w known at run time.
__device__ __forceinline__ uint32_t window_sum_scalar(
    const uint32_t* __restrict__ words, int64_t mw, int64_t p, int w) {
  const int64_t end = p + w < mw ? p + w : mw;
  uint32_t acc = 0;                        // unsigned: wraps mod 2^32
  for (int64_t q = p; q < end; ++q) acc += __ldg(words + q);
  return acc;
}

// The same sum for a compile-time W >= 4 with 16 B aligned vector loads;
// `words` must be 16 B aligned. kThroughL1: loads allocate in L1 (__ldg) or
// go to the L2 only (__ldcg; weighed by the tuning sweep).
template <int W, bool kThroughL1 = true>
__device__ __forceinline__ uint32_t window_sum_vec(
    const uint32_t* __restrict__ words, int64_t mw, int64_t p) {
  constexpr int kVecs = (W + 3 + 3) / 4;     // covers off + W <= W + 3 words
  const int64_t a = p & ~static_cast<int64_t>(3);
  const int off = static_cast<int>(p - a);
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if (4 * j >= off + W) continue;          // the window ends before it
    const int64_t q = a + 4 * j;
    uint32_t x[4];
    if (q + 4 <= mw) {
      const uint4* v = reinterpret_cast<const uint4*>(words + q);
      const uint4 t = kThroughL1 ? __ldg(v) : __ldcg(v);
      x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else {                                 // the vector crosses the end
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = q + k < mw ? __ldg(words + q + k) : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * j + k >= off && 4 * j + k < off + W) acc += x[k];
  }
  return acc;
}

// The sum for a compile-time W, the window in registers.
template <int W>
__device__ __forceinline__ uint32_t window_sum(
    const uint32_t* __restrict__ words, int64_t mw, int64_t p) {
  if constexpr (W >= 4) {
    return window_sum_vec<W>(words, mw, p);
  } else {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (p + k < mw) acc += __ldg(words + p + k);
    return acc;
  }
}

// Lane i + j * stride for j < kRowsumLanes, stride = all threads of the
// grid: every index load starts before the first window load.
template <int W>
__global__ void __launch_bounds__(kRowsumThreads)
gather_rowsum_kernel(const uint32_t* __restrict__ words, int64_t mw,
                     const int32_t* __restrict__ idx, int64_t n,
                     int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsumThreads;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsumThreads
                    + threadIdx.x;
  int32_t ix[kRowsumLanes];
#pragma unroll
  for (int j = 0; j < kRowsumLanes; ++j)
    ix[j] = i + j * stride < n ? __ldg(idx + i + j * stride) : 0;
  uint32_t acc[kRowsumLanes];
#pragma unroll
  for (int j = 0; j < kRowsumLanes; ++j)
    acc[j] = window_sum<W>(words, mw, clamp_start(ix[j], mw));
#pragma unroll
  for (int j = 0; j < kRowsumLanes; ++j)
    if (i + j * stride < n)
      out[i + j * stride] = static_cast<int32_t>(acc[j]);
}

__global__ void __launch_bounds__(kRowsumThreads)
gather_rowsum_any_kernel(const uint32_t* __restrict__ words, int64_t mw,
                         const int32_t* __restrict__ idx, int64_t n, int w,
                         int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsumThreads
                    + threadIdx.x;
  if (i >= n) return;
  const int64_t p = clamp_start(__ldg(idx + i), mw);
  out[i] = static_cast<int32_t>(window_sum_scalar(words, mw, p, w));
}

template <int W>
void launch_rowsum(const uint32_t* words, int64_t mw, const int32_t* idx,
                   int64_t n, int32_t* out, cudaStream_t stream) {
  constexpr int64_t per_block = kRowsumThreads * kRowsumLanes;
  const unsigned int blocks =
      static_cast<unsigned int>((n + per_block - 1) / per_block);
  gather_rowsum_kernel<W><<<blocks, kRowsumThreads, 0, stream>>>(
      words, mw, idx, n, out);
}

}  // namespace

// words: 32-bit [mw] (mw >= 1); idx: int32 [n]; out: int32 [n]; w >= 1.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gather_rowsum_i32(const void* words, int64_t mw,
                                 const void* idx, int64_t n, int w,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  const uint32_t* t = static_cast<const uint32_t*>(words);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(words) % 16 == 0;
  switch (aligned ? w : 0) {
    case 1: launch_rowsum<1>(t, mw, ix, n, o, s); break;
    case 2: launch_rowsum<2>(t, mw, ix, n, o, s); break;
    case 3: launch_rowsum<3>(t, mw, ix, n, o, s); break;
    case 4: launch_rowsum<4>(t, mw, ix, n, o, s); break;
    case 8: launch_rowsum<8>(t, mw, ix, n, o, s); break;
    case 16: launch_rowsum<16>(t, mw, ix, n, o, s); break;
    default:
      gather_rowsum_any_kernel<<<
          static_cast<unsigned int>((n + kRowsumThreads - 1)
                                    / kRowsumThreads),
          kRowsumThreads, 0, s>>>(t, mw, ix, n, w, o);
  }
  return static_cast<int>(cudaGetLastError());
}
