// The packed text's tables and flags for Hopper (sm_90a), derived on the
// card from the genome's uploaded base codes (uint8, 0..4 = A C G T N, as
// io/fasta.py parse_genome returns them). Same tables, bit for bit, as the
// host's plain version ops/pack.py pack_tables_ref (and real_tpu's
// text/packed.py build_packed_text):
//
//   words   16 bases a word, MSB-first, N packed as code & 3, 2 zero pads
//   nbits   the N bitmap, 32 bases a word, MSB-first, 2 zero pads
//   nb16    nbits split into 16-bit halves, high half first
//   ncum16  ncum16[g] = number of N in [0, 16g), over nb16
//   ncum    ncum[j] = number of N in [0, 32j) = ncum16[2j]
//   flags   has_n; allt32 / allt64: some window of 32 / 64 bases has two
//           all-T segments, so that a pair signature can equal the
//           0xFFFFFFFF sentinel (index/build.py orders real entries first)
//
// It replaces no TPU kernel: real_tpu packs the genome on the host in
// NumPy, and so did the port, at 0.36-1.65 s a job on the H100 machine's
// host (46.7-140 Mbp) while the card sat idle. It was added because that
// pack was the largest piece of host work every job pays.
//
// What bounds it: bytes. A base is read once (1 B of codes) and about one
// byte of tables is written (words 0.25, nbits 0.125, nb16 0.25, ncum16
// 0.25, ncum 0.125): ~2 B a base, 28 us for chr21 (46.7 Mbp) and 84 us for
// fly (140 Mbp) at 3.35 TB/s. The design streams every pass:
//
//   pack_codes_kernel  a thread per nbits word reads its 32 bases as two
//                      16 B vector loads and writes whole words: 2 text
//                      words (one 8 B store), 1 nbits word, its 2 nb16
//                      halves (one 8 B store) and the 2 halves' N counts
//                      in place in ncum16 (ncum16[0] = 0); a block vote
//                      sets has_n with one atomic a block at most.
//   the scan           ops/pack.py scans the counts in place with
//                      torch.cumsum (ncum16[1:], int32 in and out) and
//                      copies ncum from its even entries. Chosen over a
//                      block scan of our own: the counts are 2 a 32 bases
//                      (2.9M for chr21, 8.8M for fly), so the library's
//                      scan costs microseconds of a pack of 0.1-0.2 ms,
//                      and a hand scan would be ~130 lines of CUDA more.
//   all_t_kernel       reads T runs off the packed words (T packs as 11,
//                      N as 00): a word's 16-bit T mask, two of them
//                      joined, and runs of w T by shift-and-AND; a window
//                      of seedl 32 (64) has segments of 8 (16) bases at
//                      offsets 0, w, 2w, 3w, and the six segment pairs of
//                      a signature OR to "two segments of four are all
//                      T". A thread takes the 16 windows that start in
//                      each of 4 words, reading 8 words (L1/L2 hits).
//
// Positions are int64 throughout: a sub-text reaches 2^31 bases
// (engine/driver.py split_oversized). A text above ops/pack.py's chunk
// (512 Mbases) is uploaded and packed in chunks of a multiple of 32 bases
// into the same tables; the all-T pass and the scan then run once over the
// whole text. The codes buffer is padded to a multiple of 32 bytes, so the
// vector loads stay inside it; bases past the chunk's end are masked to 0.
// Every kernel launches on the caller's stream; nothing synchronises here.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): the
// launch set takes 71 us at chr21's size and 190 us at fly's, 2.5x and
// 2.3x the bound. That gap is left: it is 0.1-0.2 ms of jobs of 0.6-10 s.
// The wrapper's whole call (9.8 / 27.6 ms) is the codes' pageable upload
// (9.4 / 24.3 ms); the host's NumPy pack it replaces took 0.63 / 2.16 s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kAllTThreads = 256;
constexpr int kAllTWords = 4;                   // window words a thread takes

// flags[0] bits, read back by ops/pack.py
constexpr int kFlagHasN = 1;
constexpr int kFlagAllT32 = 2;
constexpr int kFlagAllT64 = 4;

// 4 codes (the bytes of v, first base in the low byte) -> 8 bits, 2 a
// base, the first base in the top pair; code & 3, so N packs as A.
__device__ __forceinline__ uint32_t pack4(uint32_t v) {
  const uint32_t x = v & 0x03030303u;
  return ((x & 3u) << 6) | ((x >> 4) & 0x30u) | ((x >> 14) & 0x0cu)
         | (x >> 24);
}

// 4 codes -> 4 N bits (code > 3), the first base in bit 3.
__device__ __forceinline__ uint32_t nmask4(uint32_t v) {
  const uint32_t t = (__vcmpgtu4(v, 0x03030303u) >> 7) & 0x01010101u;
  return ((t & 1u) << 3) | ((t >> 6) & 4u) | ((t >> 15) & 2u) | (t >> 24);
}

// A text word -> its 16-bit T mask, bit r = base r is T (code 3, 11).
__device__ __forceinline__ uint32_t t_mask16(uint32_t x) {
  uint32_t y = x & (x >> 1) & 0x55555555u;       // bit 2(15-r): base r
  y = (y | (y >> 1)) & 0x33333333u;              // compress the even bits
  y = (y | (y >> 2)) & 0x0f0f0f0fu;
  y = (y | (y >> 4)) & 0x00ff00ffu;
  y = (y | (y >> 8)) & 0x0000ffffu;              // bit 15-r: base r
  return __brev(y) >> 16;
}

// m: a T mask of 32 bases (bit k = base k). Bit k of the result: bases
// k .. k+7 are all T (meaningful for k <= 24).
__device__ __forceinline__ uint32_t run8(uint32_t m) {
  m &= m >> 1;
  m &= m >> 2;
  return m & (m >> 4);
}

// Whether at least two of four segment masks hold, bit by bit: the OR of
// the six segment-pair ANDs of a window (index/signatures.py PAIR_SEGMENTS).
__device__ __forceinline__ uint32_t two_of_four(uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3) {
  return (a0 & a1) | ((a0 | a1) & (a2 | a3)) | (a2 & a3);
}

// One thread per nbits word j0 + jl: its 32 bases [32 jl, 32 jl + 32) of
// the chunk, m bases long. Threads past the chunk's data (the last
// chunk's pad words) write zeros.
__global__ void __launch_bounds__(kPackThreads)
pack_codes_kernel(const uint8_t* __restrict__ codes, int64_t m, int64_t j0,
                  int64_t jcount, uint32_t* __restrict__ words,
                  int64_t words_len, uint32_t* __restrict__ nbits,
                  uint32_t* __restrict__ nb16, int32_t* __restrict__ ncum16,
                  int32_t* __restrict__ flags) {
  const int64_t jl = static_cast<int64_t>(blockIdx.x) * kPackThreads
                     + threadIdx.x;
  bool any_n = false;
  if (jl < jcount) {
    uint32_t v[8];
    const int64_t b = 32 * jl;
    if (b < m) {
      const uint4* p = reinterpret_cast<const uint4*>(codes + b);
      const uint4 lo = __ldg(p), hi = __ldg(p + 1);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      if (b + 32 > m) {                          // the chunk ends inside
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int64_t rem = m - b - 4 * q;     // bases of v[q] in range
          if (rem <= 0) v[q] = 0u;
          else if (rem < 4) v[q] &= (1u << (8 * rem)) - 1u;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = 0u;
    }
    const uint32_t w0 = (pack4(v[0]) << 24) | (pack4(v[1]) << 16)
                        | (pack4(v[2]) << 8) | pack4(v[3]);
    const uint32_t w1 = (pack4(v[4]) << 24) | (pack4(v[5]) << 16)
                        | (pack4(v[6]) << 8) | pack4(v[7]);
    uint32_t nb = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) nb |= nmask4(v[q]) << (28 - 4 * q);
    const int64_t j = j0 + jl;
    if (2 * j + 1 < words_len) {
      *reinterpret_cast<uint2*>(words + 2 * j) = make_uint2(w0, w1);
    } else if (2 * j < words_len) {
      words[2 * j] = w0;
    }
    nbits[j] = nb;
    const uint32_t h = nb >> 16, l = nb & 0xffffu;
    *reinterpret_cast<uint2*>(nb16 + 2 * j) = make_uint2(h, l);
    ncum16[2 * j + 1] = __popc(h);
    ncum16[2 * j + 2] = __popc(l);
    if (j == 0) ncum16[0] = 0;
    any_n = nb != 0u;
  }
  if (__syncthreads_or(any_n) && threadIdx.x == 0)
    atomicOr(flags, kFlagHasN);
}

// Thread g takes the windows that start in words 4g .. 4g+3 (16 each),
// up to the last window start of each seed length: n - 32 and n - 64.
__global__ void __launch_bounds__(kAllTThreads)
all_t_kernel(const uint32_t* __restrict__ words, int64_t words_len,
             int64_t n, int64_t groups, int32_t* __restrict__ flags) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kAllTThreads
                    + threadIdx.x;
  int found = 0;
  if (g < groups) {
    const int64_t t0 = g * kAllTWords;
    uint32_t tm[kAllTWords + 4];                 // T masks of 8 words
#pragma unroll
    for (int k = 0; k < kAllTWords + 4; ++k)
      tm[k] = t0 + k < words_len ? t_mask16(__ldg(words + t0 + k)) : 0u;
#pragma unroll
    for (int k = 0; k < kAllTWords; ++k) {
      const int64_t first = 16 * (t0 + k);       // window start of bit 0
      // runs over 32 bases from each of the words k .. k+3
      const uint32_t r0 = run8(tm[k] | (tm[k + 1] << 16));
      const uint32_t r1 = run8(tm[k + 1] | (tm[k + 2] << 16));
      const uint32_t r2 = run8(tm[k + 2] | (tm[k + 3] << 16));
      const uint32_t r3 = run8(tm[k + 3] | (tm[k + 4] << 16));
      // seedl 32: segments of 8 at +0, +8, +16, +24
      const uint32_t hit32 = two_of_four(r0, r0 >> 8, r1, r1 >> 8);
      // seedl 64: segments of 16 (two runs of 8) at +0, +16, +32, +48
      const uint32_t hit64 = two_of_four(r0 & (r0 >> 8), r1 & (r1 >> 8),
                                         r2 & (r2 >> 8), r3 & (r3 >> 8));
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int64_t lim = n - (s ? 64 : 32) - first;   // last start, rel.
        if (lim < 0) continue;
        const uint32_t valid = lim >= 15 ? 0xffffu
                               : (2u << lim) - 1u;
        if ((s ? hit64 : hit32) & valid)
          found |= s ? kFlagAllT64 : kFlagAllT32;
      }
    }
  }
  if (found) atomicOr(flags, found);              // rare: no vote first
}

}  // namespace

// One chunk of m codes (16 B aligned, readable to a multiple of 32 bytes
// past its start) whose first base is base 32 * j0 of the text: writes
// nbits words j0 .. j0 + jcount - 1 and the words, nb16 halves and ncum16
// counts they cover (words only below words_len). flags: int32 [1], zeroed
// by the caller before the first chunk. Returns cudaGetLastError().
extern "C" int pack_text_chunk(const void* codes, int64_t m, int64_t j0,
                               int64_t jcount, void* words, int64_t words_len,
                               void* nbits, void* nb16, void* ncum16,
                               void* flags, void* stream) {
  if (jcount <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((jcount + kPackThreads - 1) / kPackThreads);
  pack_codes_kernel<<<blocks, kPackThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), m, j0, jcount,
      static_cast<uint32_t*>(words), words_len,
      static_cast<uint32_t*>(nbits), static_cast<uint32_t*>(nb16),
      static_cast<int32_t*>(ncum16), static_cast<int32_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// After every chunk of a text of n bases (words_len words): the all-T
// flags ORed into flags[0]. Returns cudaGetLastError().
extern "C" int pack_text_finish(const void* words, int64_t words_len,
                                int64_t n, void* flags, void* stream) {
  if (n < 32) return 0;
  const int64_t starts = (n - 32) / 16 + 1;      // words holding a start
  const int64_t groups = (starts + kAllTWords - 1) / kAllTWords;
  all_t_kernel<<<static_cast<unsigned int>(
                     (groups + kAllTThreads - 1) / kAllTThreads),
                 kAllTThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), words_len, n, groups,
      static_cast<int32_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}
