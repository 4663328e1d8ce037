// The match step's three table fetches for Hopper (sm_90a), one entry point
// each, every fetch inside the kernel that consumes it:
//
//   gather_windows_i32    w consecutive 32-bit words at n start offsets (the
//                         generic window gather; the bisection path's bucket
//                         bounds go through it)
//   probe_candidates_i32  per probe: bucket bounds -> candidate range ->
//                         tier-1 list signatures -> lane validity
//   verify_windows_i32    per survivor lane: text words -> funnel shift ->
//                         XOR with the read -> masked mismatch counts
//
// Replaces the TPU kernel real_tpu/ops/pallas_gather.py:_window_call (the
// row-DMA Pallas gather behind gather_word_windows) at its three call sites
// in real_tpu/engine/matchstep.py find_survivors. The TPU kernel stages two
// 512 B table rows per lane through SMEM/VMEM with DMA semaphores because
// Mosaic offered no vector gather, and hands every fetched word back to XLA
// through HBM. A GPU thread can load any address, so none of that structure
// is carried over; what is designed here is what this card is short of.
//
// What bounds each entry (H100: 3.35 TB/s HBM, 50 MB L2, 32 B sectors):
//
// gather_windows: the card's random-access rate. A call moves 4 B of index
//   and 4w B of output per lane plus one or two 32 B sectors of table (a
//   w-word window at a random start straddles a sector boundary in (w-1)/8
//   of the lanes): under 25 MB even at 393,216 lanes, 7 us at the HBM
//   streaming rate. That bound is out of reach for scattered sectors:
//   tools/gathertune.py measures 393,216 lanes of w = 2 at 6.5 us on a
//   16 MB table (in L2) and 15.8-17.7 us on 256 MB-1 GB tables, a plateau
//   of ~23 G lanes/s on an H100 at 700 W whatever the block size.
//   Design: each thread owns 4 lanes, strided by the block so index loads
//   and stores stay coalesced; it loads its 4 indices first, then starts
//   all 4w word loads before the first store, so 4 independent round trips
//   overlap per thread (4% faster than one lane per thread at that
//   plateau, same tool; 8 lanes add 3% and cost registers). Even windows
//   at even starts load 8 bytes at a time (half as many loads). Stores
//   are [w, n]: for each k a warp writes 128 contiguous bytes.
//
// probe_candidates: three DEPENDENT round trips (probe -> bucket bounds ->
//   list signatures), of which the last two miss L2 on a real index. Bytes:
//   9 B in and 8 + 5*K1 B out per probe plus ~1.1 sectors of bucket table
//   and ~1.4 sectors of signature list: ~110 B per probe, 13 us for the
//   393,216 probes of a 32,768-read batch at the streaming rate; at the
//   random-access rate above its two scattered fetches cost what the two
//   gathers they replace do (16 + 19 us), and it runs in 40 us. Fusing
//   removes the intermediate round trip through HBM, the eager ops
//   between the two gathers and their launches; each thread owns 2
//   probes and walks them stage by stage (all probe loads, then all bound
//   loads, then all signature loads), so each dependent stage has 2
//   independent probes in flight per thread (6% faster than 1, and 4 are
//   16% slower than 2: same tool). With K1 == 4 a probe's lanes and flags
//   leave as one 16 B and one 4 B store.
//
// verify_windows: its index and output bytes. The text table (1-3 MB for
//   a bacterial or yeast genome) stays in L2, so the kw+1 word loads cost
//   L2 latency only and overlap (all started before the first use). Per lane
//   9 B in, 4*kw + 8 B out: at 65,536 lanes x kw 7 that is 2.9 MB, ~1 us at
//   the HBM rate, so the launch itself is the floor. The read's packed
//   words (8*kw B per read and strand, shared by the S lanes of a read) hit
//   L1. kw is a template parameter so the kw+1 words and the loop live in
//   registers; the per-word masks are kernel arguments (constant bank).
//
// Element types: tables are int32 holding real_tpu's uint32 bit patterns;
// all compares on signatures are done on uint32_t. Probe signatures, read
// words and positions arrive as the int64 tensors the match step computes
// (unsigned 32-bit values in int64), validity and strand as 1-byte bools.
//
// Edge rules, bit for bit those of the plain PyTorch versions
// (ops/gather.py): a window start is clamped to [0, mw-1] and words past
// the table end read 0; index sums are narrowed to int32 where the plain
// version narrows them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;       // lanes per thread, gather_windows
constexpr int kProbes = 2;      // probes per thread, probe_candidates
constexpr int kLists = 6;
constexpr int kMaxKw = 16;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int64 -> int32 as a tensor cast does it (keeps the low 32 bits)
__device__ __forceinline__ int64_t narrow32(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

__device__ __forceinline__ int32_t load_or_zero(const int32_t* __restrict__ t,
                                                int64_t q, int64_t mw) {
  return q < mw ? __ldg(t + q) : 0;
}

// ---------------------------------------------------------------------------
// gather_windows
// ---------------------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const int32_t* __restrict__ words, int64_t mw,
                      const int32_t* __restrict__ idx, int64_t n,
                      int32_t* __restrict__ out, bool aligned8) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (kThreads * kLanes)
                       + threadIdx.x;
  int64_t p[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int64_t i = base + j * kThreads;
    p[j] = i < n ? __ldg(idx + i) : 0;
  }
  int32_t v[kLanes][W];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int64_t q = clamp64(p[j], 0, mw - 1);
    if (W % 2 == 0 && aligned8 && (q & 1) == 0 && q + W <= mw) {
      const int2* src = reinterpret_cast<const int2*>(words + q);
#pragma unroll
      for (int k = 0; k < W / 2; ++k) {
        const int2 t = __ldg(src + k);
        v[j][2 * k] = t.x;
        v[j][2 * k + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) v[j][k] = load_or_zero(words, q + k, mw);
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int64_t i = base + j * kThreads;
    if (i < n) {
#pragma unroll
      for (int k = 0; k < W; ++k) out[static_cast<int64_t>(k) * n + i] = v[j][k];
    }
  }
}

// any width: the same lane ownership, the words of a lane streamed
__global__ void __launch_bounds__(kThreads)
gather_windows_any_kernel(const int32_t* __restrict__ words, int64_t mw,
                          const int32_t* __restrict__ idx, int64_t n, int w,
                          int32_t* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (kThreads * kLanes)
                       + threadIdx.x;
  int64_t p[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int64_t i = base + j * kThreads;
    p[j] = i < n ? __ldg(idx + i) : 0;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int64_t i = base + j * kThreads;
    if (i >= n) continue;
    const int64_t q = clamp64(p[j], 0, mw - 1);
    for (int k = 0; k < w; ++k)
      out[static_cast<int64_t>(k) * n + i] = load_or_zero(words, q + k, mw);
  }
}

// ---------------------------------------------------------------------------
// probe_candidates
// ---------------------------------------------------------------------------

template <int K1>
__global__ void __launch_bounds__(kThreads)
probe_candidates_kernel(const int32_t* __restrict__ sig_tab, int64_t m,
                        const int32_t* __restrict__ bb, int64_t nbuck,
                        const int64_t* __restrict__ probe,
                        const uint8_t* __restrict__ read_valid,
                        int64_t nprobe, int shift,
                        int32_t* __restrict__ begin_out,
                        int32_t* __restrict__ count_out,
                        int32_t* __restrict__ lane_out,
                        uint8_t* __restrict__ cand_out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (kThreads * kProbes)
                       + threadIdx.x;
  const int64_t nbb = kLists * nbuck;
  const int64_t nsig = kLists * m;

  // stage 1: the probes
  uint32_t sig[kProbes];
  int64_t list[kProbes];
  bool valid[kProbes];
#pragma unroll
  for (int j = 0; j < kProbes; ++j) {
    const int64_t i = base + j * kThreads;
    const bool live = i < nprobe;
    sig[j] = live ? static_cast<uint32_t>(__ldg(probe + i)) : 0u;
    list[j] = (i % (2 * kLists)) % kLists;
    valid[j] = live && __ldg(read_valid + i / (2 * kLists)) != 0;
  }

  // stage 2: bucket bounds; each list's last entry is its real-entry count
  int64_t lo[kProbes], hi[kProbes], real_end[kProbes];
#pragma unroll
  for (int j = 0; j < kProbes; ++j) {
    const int64_t h = static_cast<int64_t>(static_cast<uint64_t>(sig[j])
                                           >> shift);      // shift <= 32
    const int64_t b = clamp64(narrow32(h + list[j] * nbuck), 0, nbb - 1);
    lo[j] = __ldg(bb + b);
    hi[j] = load_or_zero(bb, b + 1, nbb);
    real_end[j] = __ldg(bb + list[j] * nbuck + nbuck - 1);
  }

  // stage 3: K1 list signatures from the clipped range start. Lanes that
  // run into the neighbouring list have lane >= count and are masked.
  int64_t count[kProbes];
  uint32_t lane[kProbes][K1];
#pragma unroll
  for (int j = 0; j < kProbes; ++j) {
    const int64_t end = hi[j] < real_end[j] ? hi[j] : real_end[j];
    const int64_t c = end - lo[j];
    count[j] = c < 2 * m ? c : 2 * m;
    const int64_t start = clamp64(
        narrow32(clamp64(lo[j], 0, m - 1) + list[j] * m), 0, nsig - 1);
#pragma unroll
    for (int k = 0; k < K1; ++k)
      lane[j][k] = static_cast<uint32_t>(load_or_zero(sig_tab, start + k,
                                                      nsig));
  }

  // stage 4: outputs, probe-major
#pragma unroll
  for (int j = 0; j < kProbes; ++j) {
    const int64_t i = base + j * kThreads;
    if (i >= nprobe) continue;
    begin_out[i] = static_cast<int32_t>(lo[j]);
    count_out[i] = static_cast<int32_t>(count[j]);
    uint8_t cand[K1];
#pragma unroll
    for (int k = 0; k < K1; ++k)
      cand[k] = (k < count[j] && lane[j][k] == sig[j] && valid[j]) ? 1 : 0;
    if (K1 == 4) {
      reinterpret_cast<int4*>(lane_out)[i] = make_int4(
          static_cast<int32_t>(lane[j][0]), static_cast<int32_t>(lane[j][1]),
          static_cast<int32_t>(lane[j][2]), static_cast<int32_t>(lane[j][3]));
      reinterpret_cast<uchar4*>(cand_out)[i] =
          make_uchar4(cand[0], cand[1], cand[2], cand[3]);
    } else {
#pragma unroll
      for (int k = 0; k < K1; ++k) {
        lane_out[i * K1 + k] = static_cast<int32_t>(lane[j][k]);
        cand_out[i * K1 + k] = cand[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// verify_windows
// ---------------------------------------------------------------------------

struct VerifyMasks {
  uint32_t tail[kMaxKw];      // bases of the window inside the read length
  uint32_t seed_s[kMaxKw];    // seed region of a straight hit
  uint32_t seed_r[kMaxKw];    // seed region of a reverse-complement hit
};

__device__ __forceinline__ int pair_mismatches(uint32_t x) {
  return __popc(((x >> 1) | x) & 0x55555555u);
}

template <int KW>
__global__ void __launch_bounds__(256)
verify_windows_kernel(const int32_t* __restrict__ words, int64_t mw,
                      const int64_t* __restrict__ pos,
                      const uint8_t* __restrict__ inv,
                      const int64_t* __restrict__ words_s,
                      const int64_t* __restrict__ words_r,
                      int64_t n, int lanes_per_read, VerifyMasks masks,
                      int32_t* __restrict__ tw, int32_t* __restrict__ totalk,
                      int32_t* __restrict__ seedk) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  const int64_t p = __ldg(pos + i);
  const bool reverse = __ldg(inv + i) != 0;
  const int64_t* __restrict__ pat =
      (reverse ? words_r : words_s) + (i / lanes_per_read) * KW;
  const int sh = static_cast<int>(p & 15) << 1;            // 0..30
  const int64_t q = clamp64(narrow32(p >> 4), 0, mw - 1);
  uint32_t t[KW + 1];
#pragma unroll
  for (int k = 0; k <= KW; ++k)
    t[k] = static_cast<uint32_t>(load_or_zero(words, q + k, mw));
  int total = 0, seed = 0;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    // upper word of (t[k]:t[k+1]) << sh; sh == 0 gives t[k] itself
    const uint32_t win = __funnelshift_l(t[k + 1], t[k], sh);
    tw[static_cast<int64_t>(k) * n + i] = static_cast<int32_t>(win);
    const uint32_t x = (win ^ static_cast<uint32_t>(__ldg(pat + k)))
                       & masks.tail[k];
    total += pair_mismatches(x);
    seed += pair_mismatches(x & (reverse ? masks.seed_r[k] : masks.seed_s[k]));
  }
  totalk[i] = total;
  seedk[i] = seed;
}

inline unsigned int blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError()
// (0 = launched); an argument the kernels do not take returns
// cudaErrorInvalidValue without launching.

// words: int32 [mw] (mw >= 1); idx: int32 [n]; out: int32 [w, n].
extern "C" int gather_windows_i32(const void* words, int64_t mw,
                                  const void* idx, int64_t n, int w,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || mw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = blocks_for(n, kThreads * kLanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tab = static_cast<const int32_t*>(words);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  const bool aligned8 = reinterpret_cast<uintptr_t>(words) % 8 == 0;
#define GATHER_CASE(W)                                                      \
  case W:                                                                   \
    gather_windows_kernel<W><<<blocks, kThreads, 0, s>>>(tab, mw, ix, n, o, \
                                                         aligned8);         \
    break;
  switch (w) {
    GATHER_CASE(1) GATHER_CASE(2) GATHER_CASE(3) GATHER_CASE(4)
    GATHER_CASE(5) GATHER_CASE(6) GATHER_CASE(7) GATHER_CASE(8)
    default:
      gather_windows_any_kernel<<<blocks, kThreads, 0, s>>>(tab, mw, ix, n, w,
                                                            o);
  }
#undef GATHER_CASE
  return static_cast<int>(cudaGetLastError());
}

// sig_tab: int32 [6*m]; bb: int32 [6*nbuck]; probe: int64 [nprobe] (nprobe a
// multiple of 12, probe = strand*6 + list within a read); read_valid: bool
// [nprobe/12]. Out: begin, count int32 [nprobe]; lanes int32 [nprobe, k1];
// cand uint8 [nprobe, k1].
extern "C" int probe_candidates_i32(const void* sig_tab, int64_t m,
                                    const void* bb, int64_t nbuck,
                                    const void* probe, const void* read_valid,
                                    int64_t nprobe, int shift, int k1,
                                    void* begin, void* count, void* lanes,
                                    void* cand, void* stream) {
  if (nprobe <= 0) return 0;
  if (m < 1 || nbuck < 1 || shift < 0 || shift > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = blocks_for(nprobe, kThreads * kProbes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROBE_CASE(K1)                                                       \
  case K1:                                                                   \
    probe_candidates_kernel<K1><<<blocks, kThreads, 0, s>>>(                 \
        static_cast<const int32_t*>(sig_tab), m,                             \
        static_cast<const int32_t*>(bb), nbuck,                              \
        static_cast<const int64_t*>(probe),                                  \
        static_cast<const uint8_t*>(read_valid), nprobe, shift,              \
        static_cast<int32_t*>(begin), static_cast<int32_t*>(count),          \
        static_cast<int32_t*>(lanes), static_cast<uint8_t*>(cand));          \
    break;
  switch (k1) {
    PROBE_CASE(1) PROBE_CASE(2) PROBE_CASE(3) PROBE_CASE(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_CASE
  return static_cast<int>(cudaGetLastError());
}

// words: int32 [mw]; pos: int64 [n]; inv: bool [n]; words_s, words_r: int64
// [n / lanes_per_read, kw]; tail, seed_s, seed_r: kw host words each.
// Out: tw int32 [kw, n]; totalk, seedk int32 [n].
extern "C" int verify_windows_i32(const void* words, int64_t mw,
                                  const void* pos, const void* inv,
                                  const void* words_s, const void* words_r,
                                  int64_t n, int lanes_per_read, int kw,
                                  const uint32_t* tail, const uint32_t* seed_s,
                                  const uint32_t* seed_r, void* tw,
                                  void* totalk, void* seedk, void* stream) {
  if (n <= 0) return 0;
  if (mw < 1 || lanes_per_read < 1 || kw < 1 || kw > kMaxKw)
    return static_cast<int>(cudaErrorInvalidValue);
  VerifyMasks masks = {};
  for (int k = 0; k < kw; ++k) {
    masks.tail[k] = tail[k];
    masks.seed_s[k] = seed_s[k];
    masks.seed_r[k] = seed_r[k];
  }
  const int threads = 256;
  const unsigned int blocks = blocks_for(n, threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VERIFY_CASE(KW)                                                     \
  case KW:                                                                  \
    verify_windows_kernel<KW><<<blocks, threads, 0, s>>>(                   \
        static_cast<const int32_t*>(words), mw,                             \
        static_cast<const int64_t*>(pos), static_cast<const uint8_t*>(inv), \
        static_cast<const int64_t*>(words_s),                               \
        static_cast<const int64_t*>(words_r), n, lanes_per_read, masks,     \
        static_cast<int32_t*>(tw), static_cast<int32_t*>(totalk),           \
        static_cast<int32_t*>(seedk));                                      \
    break;
  switch (kw) {
    VERIFY_CASE(1) VERIFY_CASE(2) VERIFY_CASE(3) VERIFY_CASE(4)
    VERIFY_CASE(5) VERIFY_CASE(6) VERIFY_CASE(7) VERIFY_CASE(8)
    VERIFY_CASE(9) VERIFY_CASE(10) VERIFY_CASE(11) VERIFY_CASE(12)
    VERIFY_CASE(13) VERIFY_CASE(14) VERIFY_CASE(15) VERIFY_CASE(16)
  }
#undef VERIFY_CASE
  return static_cast<int>(cudaGetLastError());
}
