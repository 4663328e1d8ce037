// Measurement kernels for the row-gather-sum (gather_rowsum.cu) at its
// micro-benchmark width w = 8: the floor of a scattered gather of that
// grid, the earlier design, and the designs that were weighed against the
// shipped one. Built and driven only by tools/gathertune.py (rowsum sweep);
// nothing of the port calls it. It includes gather_rowsum.cu for the
// shared device functions, so the shipped kernel is timed from this
// library as well (gather_rowsum_i32).
//
//   0 empty      a kernel of the same grid (n / 256 blocks of 256) that
//                does nothing: launch and scheduling
//   1 idx_store  out[i] = idx[i]: the index load and the store, no table
//   2 one_word   out[i] = words[clamp(idx[i])]: one dependent table word
//   3 scalar_rt  the earlier design: w at run time, w scalar loads per lane
//   4 subwarp_8  eight threads per lane, one word each, __shfl_xor_sync sum
//
// and a grid of (threads per block, lanes per thread, load form) over the
// shipped kernel's layout, rowsum_tune_grid_i32: eight scalar loads in
// registers, the aligned uint4 loads through L1 (__ldg) or past it
// (__ldcg), the lanes of a thread one grid apart so that every index load
// and store stays coalesced, and the empty kernel at each grid.

#include "gather_rowsum.cu"

namespace {

constexpr int kTuneW = 8;

__global__ void __launch_bounds__(kRowsumThreads)
tune_empty_kernel(int64_t n) {}

__global__ void __launch_bounds__(kRowsumThreads)
tune_idx_store_kernel(const int32_t* __restrict__ idx, int64_t n,
                      int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsumThreads
                    + threadIdx.x;
  if (i < n) out[i] = __ldg(idx + i);
}

__global__ void __launch_bounds__(kRowsumThreads)
tune_one_word_kernel(const uint32_t* __restrict__ words, int64_t mw,
                     const int32_t* __restrict__ idx, int64_t n,
                     int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsumThreads
                    + threadIdx.x;
  if (i < n)
    out[i] = static_cast<int32_t>(
        __ldg(words + clamp_start(__ldg(idx + i), mw)));
}

__device__ __forceinline__ uint32_t window_sum_scalar8(
    const uint32_t* __restrict__ words, int64_t mw, int64_t p) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kTuneW; ++k)
    if (p + k < mw) acc += __ldg(words + p + k);
  return acc;
}

// T threads per block, L lanes per thread one grid apart, all index loads
// started before the first window load. kMode 0: scalar loads, 1: uint4
// loads through L1, 2: uint4 loads past L1.
template <int T, int L, int kMode>
__global__ void __launch_bounds__(T)
tune_grid_kernel(const uint32_t* __restrict__ words, int64_t mw,
                 const int32_t* __restrict__ idx, int64_t n,
                 int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * T + threadIdx.x;
  int32_t ix[L];
#pragma unroll
  for (int j = 0; j < L; ++j)
    ix[j] = i + j * stride < n ? __ldg(idx + i + j * stride) : 0;
  uint32_t acc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int64_t p = clamp_start(ix[j], mw);
    acc[j] = kMode == 0 ? window_sum_scalar8(words, mw, p)
             : kMode == 1 ? window_sum_vec<kTuneW, true>(words, mw, p)
                          : window_sum_vec<kTuneW, false>(words, mw, p);
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (i + j * stride < n) out[i + j * stride] = static_cast<int32_t>(acc[j]);
}

template <int T>
__global__ void __launch_bounds__(T) tune_grid_empty_kernel(int64_t n) {}

template <int T, int L>
int launch_grid(int mode, const uint32_t* words, int64_t mw,
                const int32_t* idx, int64_t n, int32_t* out,
                cudaStream_t s) {
  const unsigned int blocks = static_cast<unsigned int>(
      (n + static_cast<int64_t>(T) * L - 1) / (static_cast<int64_t>(T) * L));
  if (mode == 0)
    tune_grid_kernel<T, L, 0><<<blocks, T, 0, s>>>(words, mw, idx, n, out);
  else if (mode == 1)
    tune_grid_kernel<T, L, 1><<<blocks, T, 0, s>>>(words, mw, idx, n, out);
  else if (mode == 2)
    tune_grid_kernel<T, L, 2><<<blocks, T, 0, s>>>(words, mw, idx, n, out);
  else
    tune_grid_empty_kernel<T><<<blocks, T, 0, s>>>(n);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch_grid_lanes(int mode, int lanes, const uint32_t* words, int64_t mw,
                      const int32_t* idx, int64_t n, int32_t* out,
                      cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_grid<T, 1>(mode, words, mw, idx, n, out, s);
    case 2: return launch_grid<T, 2>(mode, words, mw, idx, n, out, s);
    case 4: return launch_grid<T, 4>(mode, words, mw, idx, n, out, s);
    case 8: return launch_grid<T, 8>(mode, words, mw, idx, n, out, s);
    default: return -1;
  }
}

// Thread t serves word t % 8 of lane t / 8; every thread of a warp takes
// part in the shuffles, so no thread leaves early.
__global__ void __launch_bounds__(kRowsumThreads)
tune_subwarp8_kernel(const uint32_t* __restrict__ words, int64_t mw,
                     const int32_t* __restrict__ idx, int64_t n,
                     int32_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kRowsumThreads
                    + threadIdx.x;
  const int64_t i = t / kTuneW;
  const int k = static_cast<int>(t % kTuneW);
  uint32_t x = 0;
  if (i < n) {
    const int64_t q = clamp_start(__ldg(idx + i), mw) + k;
    if (q < mw) x = __ldg(words + q);
  }
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  if (k == 0 && i < n) out[i] = static_cast<int32_t>(x);
}

}  // namespace

// One launch of measurement kernel `variant` (the list above) over the
// row-gather-sum's arguments at w = 8. Returns cudaGetLastError(), or -1
// for arguments the variant does not take.
extern "C" int rowsum_tune_i32(int variant, const void* words, int64_t mw,
                               const void* idx, int64_t n, void* out,
                               void* stream) {
  if (n <= 0) return -1;
  const uint32_t* t = static_cast<const uint32_t*>(words);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto grid = [](int64_t threads) {
    return static_cast<unsigned int>(
        (threads + kRowsumThreads - 1) / kRowsumThreads);
  };
  switch (variant) {
    case 0:
      tune_empty_kernel<<<grid(n), kRowsumThreads, 0, s>>>(n);
      break;
    case 1:
      tune_idx_store_kernel<<<grid(n), kRowsumThreads, 0, s>>>(ix, n, o);
      break;
    case 2:
      tune_one_word_kernel<<<grid(n), kRowsumThreads, 0, s>>>(t, mw, ix, n,
                                                              o);
      break;
    case 3:
      gather_rowsum_any_kernel<<<grid(n), kRowsumThreads, 0, s>>>(
          t, mw, ix, n, kTuneW, o);
      break;
    case 4:
      tune_subwarp8_kernel<<<grid(n * kTuneW), kRowsumThreads, 0, s>>>(
          t, mw, ix, n, o);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of the grid kernel: mode 0 eight scalar loads, 1 aligned uint4
// loads through L1, 2 the same past L1, 3 the empty kernel; threads in {64, 128, 256, 512, 1024}, lanes in
// {1, 2, 4, 8}. Returns cudaGetLastError(), or -1 for other arguments.
extern "C" int rowsum_tune_grid_i32(int mode, int threads, int lanes,
                                    const void* words, int64_t mw,
                                    const void* idx, int64_t n, void* out,
                                    void* stream) {
  if (n <= 0 || mode < 0 || mode > 3
      || reinterpret_cast<uintptr_t>(words) % 16)
    return -1;
  const uint32_t* t = static_cast<const uint32_t*>(words);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 64: return launch_grid_lanes<64>(mode, lanes, t, mw, ix, n, o, s);
    case 128: return launch_grid_lanes<128>(mode, lanes, t, mw, ix, n, o, s);
    case 256: return launch_grid_lanes<256>(mode, lanes, t, mw, ix, n, o, s);
    case 512: return launch_grid_lanes<512>(mode, lanes, t, mw, ix, n, o, s);
    case 1024:
      return launch_grid_lanes<1024>(mode, lanes, t, mw, ix, n, o, s);
    default: return -1;
  }
}

// Sets (bytes > 0) or clears (bytes == 0) an L2 access-policy window over
// [base, base + bytes) on `stream`, with as much of the L2 set aside for
// persisting lines as the device allows (*carve_out, bytes). Returns the
// first CUDA error, 0 if none.
extern "C" int rowsum_tune_l2_window(const void* base, int64_t bytes,
                                     int64_t* carve_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamAttrValue attr = {};
  if (bytes > 0) {
    int dev = 0, max_carve = 0, max_window = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&max_carve,
                               cudaDevAttrMaxPersistingL2CacheSize, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&max_window,
                               cudaDevAttrMaxAccessPolicyWindowSize, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t carve = max_carve;
    if (bytes > max_window) bytes = max_window;
    *carve_out = carve;
    e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                           static_cast<size_t>(carve));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr.accessPolicyWindow.base_ptr = const_cast<void*>(base);
    attr.accessPolicyWindow.num_bytes = static_cast<size_t>(bytes);
    attr.accessPolicyWindow.hitRatio =
        bytes <= carve ? 1.0f
                       : static_cast<float>(carve) / static_cast<float>(bytes);
    attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  } else {
    attr.accessPolicyWindow.num_bytes = 0;
  }
  cudaError_t e = cudaStreamSetAttribute(
      s, cudaStreamAttributeAccessPolicyWindow, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bytes <= 0) {
    e = cudaCtxResetPersistingL2Cache();
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
  }
  return static_cast<int>(e);
}
