// A match step's survivor lanes, scored and folded into each read's best
// hit, for Hopper (sm_90a), in one launch (K4). Two halves, each on or off
// by the call site (ops/scorefold.py score_fold):
//
//   score  score = f32(1.0 + sum_i LL[ref_i, pat_i, q_i]) of every (read,
//          lane), the sum taken in float64 one base at a time in base order
//          (ComputeScore.hpp:47-191): ref from the lane's window words (the
//          int32 words verify_windows returns), pat and q from the read's
//          codes and qualities, reverse-complemented for an inv lane; no
//          qualities (FASTA) is the constant 30.
//   fold   the UpdateUniqueInfo automaton over each read's lanes in lane
//          (merge) order (matchUniqueImplementation.cpp:97-160 without
//          scores, :179-248 with), from the read's state in to its state
//          out; f32 `score +- eps` compares as written.
//
// Bit for bit the plain loops it replaces on the card
// (engine/matchstep.py score_survivors and fold_unique, which CPU tensors
// still take): every f64 add is __dadd_rn in base order (no tree sum, no
// FMA: there is no product to fuse), the f64 -> f32 rounding is
// __double2float_rn as a tensor cast does it, and the fold's two f32 sums
// are __fadd_rn / __fsub_rn.
//
// It replaces no Pallas kernel. It is the CUDA counterpart of real_tpu's
// compiled loops, lax.fori_loop in real_tpu/engine/matchstep.py
// score_survivors (its 'f64' mode) and lax.scan in fold_unique: eager
// PyTorch has no compiled loop, so the port ran both in Python, ~30 + patl
// small kernels to score and 44 a lane to fold, about 590 launches a fly
// main step (S = 8) and 5,900 a rerun step (S = 128), ~10 us of dispatch
// each. It was added because that dispatch was most of the match loop's
// time.
//
// What bounds it: bytes. At fly's main shape (B 32,768 x S 8, patl 100)
// a step reads the window words (4 B x 7 words a lane, 7.3 MB), the reads'
// codes (3.3 MB; FASTQ qualities as much again), the lanes' fields (14 B
// a lane) and the state (24 B a read) and writes a score a lane and the
// state: 16.9 MB, 5.0 us at 3.35 TB/s. Its 26M f64 adds and table lookups
// (64 f64 adds a clock an SM) are below that. The design:
//
//   a thread a lane   a block of 256 threads scores 256 consecutive lanes;
//                     consecutive threads read consecutive window words
//                     (tw is [kw, B, L]), the read's codes and qualities
//                     come through L1 (a read's L lanes share them), the
//                     1,024-entry LL table (8 KB of f64) sits in shared
//                     memory. Nothing of [B, L, patl] is ever stored: the
//                     plain loops made five such int64/f64 tensors a step.
//   a thread a read   with the fold on, a block takes R = 256 / L whole
//                     reads (one when L > 256) and walks their lanes in
//                     chunks of 256: the chunk's threads score their lanes
//                     and put each lane's fields in shared memory, then
//                     thread r < R steps read r's automaton over its lanes
//                     of the chunk, its state in registers from the first
//                     chunk to the last. So S 8 x B 32,768 runs 1,024
//                     blocks of 32 reads, and S 128 / 2,048 x B 512 runs
//                     256 / 512 blocks, the fold's sequential walk (2,048
//                     steps at most) inside one block.
//
// Every kernel launches on the caller's stream; nothing synchronises here.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py 4c, score
// and fold): 30.6 / 38.3 us at chr21's and fly's main shapes (6-8x the
// bound: each lane's sum is a chain of patl dependent f64 adds, and the
// block waits for its fold warp), 21.2 us at B 512 x S 128 and 292 us at
// B 512 x S 2,048, where one thread walks a read's 2,048 lanes. That gap is
// left: K4 is 7 ms of a 6 s fly job. The plain loops it replaces took
// 4.2 / 5.5 / 48 / 732 ms of the host's dispatch at the same shapes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLL = 1024;            // LL[(ref << 8) | (pat << 6) | q]
constexpr int kFastaQual = 30;       // Pattern.hpp:42-45

// automaton states (UniqueMatchInfo.hpp:71-78)
constexpr int32_t kNoMatch = 0, kStraight = 1, kReverse = 2, kGapped = 3,
                  kNonUnique = 4;

struct Params {
  // the lanes, [B, L] row-major
  const uint8_t* valid;
  const uint8_t* inv;
  const int32_t* pos;
  const int32_t* frag;
  const int32_t* k;
  const float* score_in;       // the fold's scores when the score half is off
  int64_t B;
  int L;
  // the score half (tw == nullptr: off)
  const int32_t* tw;           // [kw, B, L] window words, MSB-first
  int kw;
  int patl;
  const uint8_t* codes;        // [B, >= patl], row stride codes_stride
  int64_t codes_stride;
  const int8_t* quals;         // like codes; nullptr: FASTA's constant 30
  int64_t quals_stride;
  const double* ll;            // [kLL]
  float* score_out;            // [B, L]
  // the fold half (st == nullptr: off), each [B]
  const int32_t* st;
  const int32_t* spos;
  const int32_t* sfrag;
  const int32_t* sfid;
  const int32_t* serrs;
  const float* sscore;
  int32_t* st_out;
  int32_t* spos_out;
  int32_t* sfrag_out;
  int32_t* sfid_out;
  int32_t* serrs_out;
  float* sscore_out;
  int32_t fileid;
  float eps;
  bool scores;                 // compare scores (else mismatch counts)
  int reads_per_block;         // R, with the fold on
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

struct State {
  int32_t st, pos, frag, fid, errs;
  float score;
};

__device__ __forceinline__ float lane_score(const Params& p, int64_t g,
                                            const double* __restrict__ ll) {
  const int64_t b = g / p.L;
  const uint8_t* __restrict__ cr = p.codes + b * p.codes_stride;
  const int8_t* __restrict__ qr =
      p.quals != nullptr ? p.quals + b * p.quals_stride : nullptr;
  const bool inv = p.inv[g] != 0;
  const int64_t lanes = p.B * p.L;
  double acc = 1.0;
  for (int w = 0; w < p.kw; ++w) {
    const uint32_t word = static_cast<uint32_t>(__ldg(p.tw + w * lanes + g));
    const int nb = min(16, p.patl - 16 * w);
    for (int j = 0; j < nb; ++j) {
      const int i = 16 * w + j;
      const int src = inv ? p.patl - 1 - i : i;
      const uint32_t ref = (word >> (30 - 2 * j)) & 3u;
      const uint32_t c = __ldg(cr + src) & 3u;
      const uint32_t pat = inv ? 3u - c : c;
      int q = qr != nullptr ? static_cast<int>(__ldg(qr + src)) : kFastaQual;
      q = min(max(q, 0), 63);
      acc = __dadd_rn(acc,
                      ll[(ref << 8) | (pat << 6) | static_cast<uint32_t>(q)]);
    }
  }
  return __double2float_rn(acc);
}

// one UpdateUniqueInfo step of a read's state on one lane
__device__ __forceinline__ void fold_step(State& s, bool valid, bool inv,
                                          int32_t pos, int32_t frag,
                                          int32_t k, float score,
                                          const Params& p) {
  const bool is_open = s.st == kNoMatch || s.st == kGapped;
  const bool is_hit = s.st == kStraight || s.st == kReverse;
  const bool is_nu = s.st == kNonUnique;
  const bool diff = pos != s.pos || frag != s.frag || s.fid != p.fileid;
  bool take, tie;
  if (p.scores) {
    const bool better = score > __fadd_rn(s.score, p.eps);
    const bool within = score > __fsub_rn(s.score, p.eps);
    take = valid && (is_open || ((is_hit || is_nu) && better));
    tie = valid && is_hit && !better && within && diff;
  } else {
    const bool better = k < s.errs;
    take = valid && (is_open || ((is_hit || is_nu) && better));
    tie = valid && is_hit && k == s.errs && diff;
  }
  if (take) {
    s.st = inv ? kReverse : kStraight;
    s.pos = pos;
    s.frag = frag;
    s.fid = p.fileid;
    s.errs = k;
    if (p.scores) s.score = score;
  } else if (tie) {
    s.st = kNonUnique;
  }
}

__global__ void __launch_bounds__(kThreads) score_fold_kernel(const Params p) {
  __shared__ double ll[kLL];
  __shared__ uint8_t c_valid[kThreads], c_inv[kThreads];
  __shared__ int32_t c_pos[kThreads], c_frag[kThreads], c_k[kThreads];
  __shared__ float c_score[kThreads];

  const bool score = p.tw != nullptr;
  const bool fold = p.st != nullptr;
  const int t = threadIdx.x;
  if (score) {
    for (int i = t; i < kLL; i += kThreads) ll[i] = __ldg(p.ll + i);
    __syncthreads();
  }

  int64_t lane0, lane1, read0 = 0;
  int nread = 0;
  if (fold) {
    read0 = static_cast<int64_t>(blockIdx.x) * p.reads_per_block;
    nread = static_cast<int>(min64(p.reads_per_block, p.B - read0));
    lane0 = read0 * p.L;
    lane1 = lane0 + static_cast<int64_t>(nread) * p.L;
  } else {
    lane0 = static_cast<int64_t>(blockIdx.x) * kThreads;
    lane1 = min64(lane0 + kThreads, p.B * p.L);
  }

  State s{};
  const int64_t r = read0 + t;
  if (fold && t < nread) {
    s = State{p.st[r], p.spos[r], p.sfrag[r], p.sfid[r], p.serrs[r],
              p.sscore[r]};
  }

  for (int64_t c = lane0; c < lane1; c += kThreads) {
    const int64_t g = c + t;
    if (g < lane1) {
      const float sc = score ? lane_score(p, g, ll)
                             : (fold ? p.score_in[g] : 0.0f);
      if (score) p.score_out[g] = sc;
      if (fold) {
        c_valid[t] = p.valid[g];
        c_inv[t] = p.inv[g];
        c_pos[t] = p.pos[g];
        c_frag[t] = p.frag[g];
        c_k[t] = p.k[g];
        c_score[t] = sc;
      }
    }
    if (fold) {
      __syncthreads();
      if (t < nread) {
        const int64_t a = max64(c, r * p.L);
        const int64_t e = min64(c + kThreads, (r + 1) * p.L);
        for (int64_t x = a - c; x < e - c; ++x)
          fold_step(s, c_valid[x] != 0, c_inv[x] != 0, c_pos[x], c_frag[x],
                    c_k[x], c_score[x], p);
      }
      __syncthreads();
    }
  }

  if (fold && t < nread) {
    p.st_out[r] = s.st;
    p.spos_out[r] = s.pos;
    p.sfrag_out[r] = s.frag;
    p.sfid_out[r] = s.fid;
    p.serrs_out[r] = s.errs;
    p.sscore_out[r] = s.score;
  }
}

}  // namespace

// Score and/or fold the [B, L] lanes in one launch on `stream`: the score
// half runs when tw is not null, the fold half when st is not null (both
// may run). Returns cudaGetLastError().
extern "C" int score_fold(
    const void* valid, const void* inv, const void* pos, const void* frag,
    const void* k, const void* score_in, int64_t B, int L,
    const void* tw, int kw, int patl, const void* codes, int64_t codes_stride,
    const void* quals, int64_t quals_stride, const void* ll, void* score_out,
    const void* st, const void* spos, const void* sfrag, const void* sfid,
    const void* serrs, const void* sscore, void* st_out, void* spos_out,
    void* sfrag_out, void* sfid_out, void* serrs_out, void* sscore_out,
    int fileid, float eps, int scores, void* stream) {
  Params p;
  p.valid = static_cast<const uint8_t*>(valid);
  p.inv = static_cast<const uint8_t*>(inv);
  p.pos = static_cast<const int32_t*>(pos);
  p.frag = static_cast<const int32_t*>(frag);
  p.k = static_cast<const int32_t*>(k);
  p.score_in = static_cast<const float*>(score_in);
  p.B = B;
  p.L = L;
  p.tw = static_cast<const int32_t*>(tw);
  p.kw = kw;
  p.patl = patl;
  p.codes = static_cast<const uint8_t*>(codes);
  p.codes_stride = codes_stride;
  p.quals = static_cast<const int8_t*>(quals);
  p.quals_stride = quals_stride;
  p.ll = static_cast<const double*>(ll);
  p.score_out = static_cast<float*>(score_out);
  p.st = static_cast<const int32_t*>(st);
  p.spos = static_cast<const int32_t*>(spos);
  p.sfrag = static_cast<const int32_t*>(sfrag);
  p.sfid = static_cast<const int32_t*>(sfid);
  p.serrs = static_cast<const int32_t*>(serrs);
  p.sscore = static_cast<const float*>(sscore);
  p.st_out = static_cast<int32_t*>(st_out);
  p.spos_out = static_cast<int32_t*>(spos_out);
  p.sfrag_out = static_cast<int32_t*>(sfrag_out);
  p.sfid_out = static_cast<int32_t*>(sfid_out);
  p.serrs_out = static_cast<int32_t*>(serrs_out);
  p.sscore_out = static_cast<float*>(sscore_out);
  p.fileid = fileid;
  p.eps = eps;
  p.scores = scores != 0;
  p.reads_per_block = L > 0 && L < kThreads ? kThreads / L : 1;
  const int64_t blocks =
      st != nullptr ? (B + p.reads_per_block - 1) / p.reads_per_block
                    : (B * L + kThreads - 1) / kThreads;
  if (blocks <= 0) return 0;
  score_fold_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
