// Native host-side pipeline of real_tpu_torch: read and genome parsing,
// 2-bit row packing, output record formatting and the matchAll hit sort.
// The counterpart of the reference's C++ input and output stack
// (FastAReader.hpp / FastQReader.hpp / TemporaryFile.hpp binary rewrite,
// the record stream loops, ParallelRadixSort.hpp). The parsers make one
// pass to count records and a second to fill dense buffers; both are
// branch-light byte scans, so the host phases around the device's match
// loop stay short.
//
// Exposed through a C ABI and loaded with ctypes (native/__init__.py
// builds it with the host compiler at first use). Each entry has a plain
// NumPy version in the package, and the two agree exactly.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <utility>

namespace {

// A,C,G,T -> 0..3, everything else -> 4 (N). Matches acgtnMap.hpp:39-49.
struct MapTable {
    uint8_t t[256];
    MapTable() {
        memset(t, 4, sizeof(t));
        t[uint8_t('A')] = 0; t[uint8_t('C')] = 1;
        t[uint8_t('G')] = 2; t[uint8_t('T')] = 3;
    }
};
const MapTable MAP;

struct SpaceTable {
    bool t[256];
    SpaceTable() {
        memset(t, 0, sizeof(t));
        t[uint8_t(' ')] = t[uint8_t('\t')] = t[uint8_t('\r')] =
            t[uint8_t('\n')] = t[uint8_t('\v')] = t[uint8_t('\f')] = true;
    }
};
const SpaceTable SPACE;

inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', end - p);
    return nl ? nl : end;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// FASTA reads ('>' records, multi-line sequences, whitespace stripped)
// ---------------------------------------------------------------------------

// Pass 1: count records, total sequence bases, total id bytes.
void fasta_reads_count(const uint8_t* buf, int64_t n,
                       int64_t* num_reads, int64_t* total_bases,
                       int64_t* total_id_bytes) {
    int64_t reads = 0, bases = 0, idb = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    bool in_record = false;
    while (p < end) {
        const uint8_t* nl = find_nl(p, end);
        if (*p == '>') {
            ++reads;
            in_record = true;
            idb += (nl - p) - 1;
        } else if (in_record) {
            for (const uint8_t* q = p; q < nl; ++q)
                if (!SPACE.t[*q]) ++bases;
        }
        p = nl + 1;
    }
    *num_reads = reads;
    *total_bases = bases;
    *total_id_bytes = idb;
}

// Pass 2: fill codes (mapped 0..4), per-read offsets (len num_reads+1),
// id bytes and id offsets (len num_reads+1).
void fasta_reads_fill(const uint8_t* buf, int64_t n,
                      uint8_t* codes, int64_t* offsets,
                      uint8_t* ids, int64_t* id_offsets) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    int64_t r = -1, c = 0, ib = 0;
    offsets[0] = 0;
    id_offsets[0] = 0;
    while (p < end) {
        const uint8_t* nl = find_nl(p, end);
        if (*p == '>') {
            ++r;
            offsets[r] = c;
            int64_t len = (nl - p) - 1;
            memcpy(ids + ib, p + 1, len);
            ib += len;
            id_offsets[r + 1] = ib;
        } else if (r >= 0) {
            for (const uint8_t* q = p; q < nl; ++q)
                if (!SPACE.t[*q]) codes[c++] = MAP.t[*q];
        }
        p = nl + 1;
    }
    offsets[r + 1] = c;
}

// ---------------------------------------------------------------------------
// FASTQ (strict 4-line records; quality offset subtracted by caller)
// Returns 0 on success, -1 if the structure is not 4-line-regular
// (the caller then takes the general parser, which reports the fault).
// ---------------------------------------------------------------------------

int fastq_reads_count(const uint8_t* buf, int64_t n,
                      int64_t* num_reads, int64_t* total_bases,
                      int64_t* total_id_bytes) {
    int64_t reads = 0, bases = 0, idb = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    while (p < end) {
        if (*p != '@') return -1;
        const uint8_t* nl0 = find_nl(p, end);
        idb += (nl0 - p) - 1;
        const uint8_t* s = nl0 + 1;
        if (s >= end) return -1;
        const uint8_t* nl1 = find_nl(s, end);
        int64_t slen = 0;
        for (const uint8_t* q = s; q < nl1; ++q)
            if (!SPACE.t[*q]) ++slen;
        bases += slen;
        const uint8_t* plus = nl1 + 1;
        if (plus >= end || *plus != '+') return -1;
        const uint8_t* nl2 = find_nl(plus, end);
        const uint8_t* qual = nl2 + 1;
        if (qual > end) return -1;
        const uint8_t* nl3 = find_nl(qual, end);
        int64_t qlen = 0;
        for (const uint8_t* q = qual; q < nl3; ++q)
            if (!SPACE.t[*q]) ++qlen;
        if (qlen != slen) return -1;
        ++reads;
        p = nl3 + 1;
    }
    *num_reads = reads;
    *total_bases = bases;
    *total_id_bytes = idb;
    return 0;
}

int fastq_reads_fill(const uint8_t* buf, int64_t n,
                     uint8_t* codes, int8_t* quals, int64_t* offsets,
                     uint8_t* ids, int64_t* id_offsets,
                     int32_t quality_offset) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    int64_t r = 0, c = 0, ib = 0;
    offsets[0] = 0;
    id_offsets[0] = 0;
    while (p < end) {
        const uint8_t* nl0 = find_nl(p, end);
        int64_t idlen = (nl0 - p) - 1;
        memcpy(ids + ib, p + 1, idlen);
        ib += idlen;
        id_offsets[r + 1] = ib;
        const uint8_t* s = nl0 + 1;
        const uint8_t* nl1 = find_nl(s, end);
        for (const uint8_t* q = s; q < nl1; ++q)
            if (!SPACE.t[*q]) codes[c++] = MAP.t[*q];
        const uint8_t* plus = nl1 + 1;
        const uint8_t* nl2 = find_nl(plus, end);
        const uint8_t* qv = nl2 + 1;
        const uint8_t* nl3 = find_nl(qv, end);
        int64_t qc = offsets[r];
        for (const uint8_t* q = qv; q < nl3; ++q)
            if (!SPACE.t[*q]) quals[qc++] = int8_t(int32_t(*q)
                                                   - quality_offset);
        if (qc != c) return -1;
        ++r;
        offsets[r] = c;
        p = nl3 + 1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Genome FASTA (countReads.cpp semantics: only uppercase ACGTN kept)
// ---------------------------------------------------------------------------

void genome_count(const uint8_t* buf, int64_t n,
                  int64_t* total_bases, int64_t* num_fragments,
                  int64_t* total_id_bytes) {
    int64_t bases = 0, frags = 0, idb = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    while (p < end) {
        const uint8_t* nl = find_nl(p, end);
        if (*p == '>') {
            if (nl < end) {  // only newline-terminated headers count
                ++frags;
                idb += (nl - p) - 1;
            }
        } else {
            for (const uint8_t* q = p; q < nl; ++q) {
                uint8_t m = MAP.t[*q];
                if (m < 4 || *q == 'N') ++bases;
            }
        }
        p = nl + 1;
    }
    *total_bases = bases;
    *num_fragments = frags;
    *total_id_bytes = idb;
}

void genome_fill(const uint8_t* buf, int64_t n,
                 uint8_t* codes, int64_t* frag_offsets,
                 uint8_t* ids, int64_t* id_offsets) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    int64_t c = 0, f = 0, ib = 0;
    id_offsets[0] = 0;
    while (p < end) {
        const uint8_t* nl = find_nl(p, end);
        if (*p == '>') {
            if (nl < end) {
                frag_offsets[f] = c;
                int64_t len = (nl - p) - 1;
                memcpy(ids + ib, p + 1, len);
                ib += len;
                id_offsets[f + 1] = ib;
                ++f;
            }
        } else {
            for (const uint8_t* q = p; q < nl; ++q) {
                uint8_t m = MAP.t[*q];
                if (m < 4) codes[c++] = m;
                else if (*q == 'N') codes[c++] = 4;
            }
        }
        p = nl + 1;
    }
}

// ---------------------------------------------------------------------------
// Output record formatting (matchUniqueImplementation.cpp:265-291 layout):
//   read_id \t seq[matched orientation] \t [score] \t 1 \t a \t patl \t
//   +/- \t fragment_id \t 1-based-local-pos \t <empty> \t k \n
// The score column is C++ `ostream << float` = "%.6g" of the float32
// widened to double. Returns bytes written, or -1 if out_cap would be
// exceeded (caller sizes out with format_records_bound, so this is a
// programming error, not a runtime path).
// ---------------------------------------------------------------------------

int64_t format_records_bound(int64_t n, const int64_t* pid,
                             const int64_t* id_off, const int64_t* code_off,
                             const int64_t* name_idx,
                             const int64_t* name_off) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t p = pid[i];
        total += (id_off[p + 1] - id_off[p])
                 + (code_off[p + 1] - code_off[p])
                 + (name_off[name_idx[i] + 1] - name_off[name_idx[i]])
                 + 80;  // tabs + ints + score + strand + newline
    }
    return total;
}

int64_t format_records(
        int64_t n,
        const uint8_t* id_blob, const int64_t* id_off,
        const uint8_t* codes_flat, const int64_t* code_off,
        const int64_t* pid,          // [n] read index (may repeat)
        const uint8_t* inv,          // [n] 1 = reverse-complement hit
        const float* score,          // [n] or NULL (scores off)
        const uint8_t* name_blob, const int64_t* name_off,
        const int64_t* name_idx,     // [n] global fragment-name index
        const int64_t* local_pos,    // [n] 1-based position in fragment
        const int32_t* errs,         // [n]
        uint8_t* out, int64_t out_cap) {
    static const char FWD[5] = {'A', 'C', 'G', 'T', 'N'};
    static const char REV[5] = {'T', 'G', 'C', 'A', 'N'};
    uint8_t* w = out;
    uint8_t* lim = out + out_cap;
    for (int64_t i = 0; i < n; ++i) {
        int64_t p = pid[i];
        int64_t idl = id_off[p + 1] - id_off[p];
        int64_t sl = code_off[p + 1] - code_off[p];
        int64_t nmi = name_idx[i];
        int64_t nml = name_off[nmi + 1] - name_off[nmi];
        if (w + idl + sl + nml + 80 > lim) return -1;
        memcpy(w, id_blob + id_off[p], idl);
        w += idl;
        *w++ = '\t';
        const uint8_t* src = codes_flat + code_off[p];
        if (inv[i]) {
            for (int64_t j = sl - 1; j >= 0; --j) *w++ = REV[src[j]];
        } else {
            for (int64_t j = 0; j < sl; ++j) *w++ = FWD[src[j]];
        }
        *w++ = '\t';
        if (score) {
            w += snprintf((char*)w, 32, "%.6g", (double)score[i]);
            *w++ = '\t';
        } else {
            *w++ = '\t';  // empty score column
        }
        *w++ = '1'; *w++ = '\t'; *w++ = 'a'; *w++ = '\t';
        w += snprintf((char*)w, 24, "%lld", (long long)sl);
        *w++ = '\t';
        *w++ = inv[i] ? '-' : '+';
        *w++ = '\t';
        memcpy(w, name_blob + name_off[nmi], nml);
        w += nml;
        *w++ = '\t';
        w += snprintf((char*)w, 24, "%lld", (long long)local_pos[i]);
        *w++ = '\t';
        *w++ = '\t';  // empty type column
        w += snprintf((char*)w, 16, "%d", errs[i]);
        *w++ = '\n';
    }
    return w - out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Stable LSD radix argsort over up to three u64 keys (k0 least significant).
// The counterpart of the reference's ParallelRadixSort.hpp for the
// matchAll hit-unification sort (matchAllImplementation.cpp:121-161):
// byte-wise counting passes, constant bytes skipped, permutation carried.
// ---------------------------------------------------------------------------

namespace {

constexpr int kDigitBits = 11;                 // 2048 buckets, like the
constexpr int kBuckets = 1 << kDigitBits;      // reference's radix sort

// One stable counting pass on digit (cur >> shift): permutes (cur, nxt,
// idx) SoA triples into the tmp arrays and swaps. Sequential reads,
// 2048-stream writes — no random gathers.
void radix_pass11(uint64_t*& cur, uint64_t*& nxt, int64_t*& idx,
                  uint64_t*& tcur, uint64_t*& tnxt, int64_t*& tidx,
                  int shift, int64_t n, int64_t* count) {
    memset(count, 0, kBuckets * sizeof(int64_t));
    const uint64_t mask = kBuckets - 1;
    for (int64_t i = 0; i < n; ++i)
        ++count[(cur[i] >> shift) & mask];
    if (count[(cur[0] >> shift) & mask] == n) return;   // constant digit
    int64_t sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
        int64_t c = count[b];
        count[b] = sum;
        sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t d = count[(cur[i] >> shift) & mask]++;
        tcur[d] = cur[i];
        tnxt[d] = nxt[i];
        tidx[d] = idx[i];
    }
    std::swap(cur, tcur);
    std::swap(nxt, tnxt);
    std::swap(idx, tidx);
}

}  // namespace

extern "C" {

// Stable argsort by the composite order (k2, k1, k0) — k0 least
// significant. LSD over 11-bit digits of k0, then k1, then k2; while
// digit passes of key j run, key j+1 rides along so it is permutation-
// consistent when its turn comes (k0 never needs to ride: it is consumed
// first; k2 rides during k1's passes via the nxt slot).
void radix_argsort3(int64_t n, const uint64_t* k0, const uint64_t* k1,
                    const uint64_t* k2, int64_t* idx_out) {
    for (int64_t i = 0; i < n; ++i) idx_out[i] = i;
    if (n < 2) return;
    uint64_t* bufa = new uint64_t[n];
    uint64_t* bufb = new uint64_t[n];
    uint64_t* bufc = new uint64_t[n];
    uint64_t* bufd = new uint64_t[n];
    int64_t* idx = idx_out;
    int64_t* tidx = new int64_t[n];
    int64_t* count = new int64_t[kBuckets];

    const uint64_t* keys[3] = {k0, k1, k2};
    uint64_t *cur = bufa, *nxt = bufb, *tcur = bufc, *tnxt = bufd;
    // load k0 into cur and k1 into nxt (both in original order)
    memcpy(cur, k0, n * sizeof(uint64_t));
    memcpy(nxt, k1, n * sizeof(uint64_t));
    for (int kk = 0; kk < 3; ++kk) {
        uint64_t mx = 0;
        const uint64_t* src = keys[kk];
        for (int64_t i = 0; i < n; ++i)
            if (src[i] > mx) mx = src[i];
        for (int shift = 0; shift < 64 && (mx >> shift);
             shift += kDigitBits)
            radix_pass11(cur, nxt, idx, tcur, tnxt, tidx, shift, n, count);
        if (kk == 2) break;
        // promote: nxt becomes the active key; load the following key
        // (permuted by idx) into the nxt slot
        std::swap(cur, nxt);
        if (kk == 0) {
            for (int64_t i = 0; i < n; ++i) nxt[i] = k2[idx[i]];
        }
    }
    if (idx != idx_out) {
        memcpy(idx_out, idx, n * sizeof(int64_t));
        delete[] idx;
    } else {
        delete[] tidx;
    }
    delete[] bufa; delete[] bufb; delete[] bufc; delete[] bufd;
    delete[] count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// 2-bit row packing (the reference's TemporaryFile.hpp byte packing widened
// to words): codes [rows x row_len] -> uint32 words MSB-first, 16 bases per
// word. Codes 4 (N) pack as their low two bits; the caller masks such rows.
// ---------------------------------------------------------------------------

extern "C" {

void pack_rows_2bit(const uint8_t* codes, int64_t rows, int64_t row_len,
                    uint32_t* out, int64_t words_per_row) {
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = codes + r * row_len;
        uint32_t* dst = out + r * words_per_row;
        for (int64_t w = 0; w < words_per_row; ++w) {
            uint32_t v = 0;
            int64_t base = w * 16;
            int64_t lim = row_len - base;
            if (lim > 16) lim = 16;
            for (int64_t i = 0; i < lim; ++i)
                v |= uint32_t(src[base + i] & 3) << (2 * (15 - i));
            dst[w] = v;
        }
    }
}

}  // extern "C"
