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

#include <cmath>
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

}  // extern "C"

// ---------------------------------------------------------------------------
// The record formatter's numbers, written without printf on the common
// path: "%lld" of an integer by two digits a lookup, and "%.6g" of a
// float32 widened to double in 64-bit integer arithmetic, exact for 0 and
// 1e-3 <= |f| < 1e9 (every score of a 50-150 bp read but those within
// 1e-3 of zero); snprintf writes the rest and is counted.
// ---------------------------------------------------------------------------

namespace {

struct DigitPairs {
    char t[200];                // "00" "01" ... "99"
    DigitPairs() {
        for (int i = 0; i < 100; ++i) {
            t[2 * i] = char('0' + i / 10);
            t[2 * i + 1] = char('0' + i % 10);
        }
    }
};
const DigitPairs PAIRS;

const uint64_t POW10[10] = {1ull, 10ull, 100ull, 1000ull, 10000ull,
                            100000ull, 1000000ull, 10000000ull,
                            100000000ull, 1000000000ull};

// "%llu" of v; returns the bytes written (at most 20).
inline int write_u64(char* w, uint64_t v) {
    char buf[20];
    char* p = buf + 20;
    while (v >= 100) {
        uint64_t q = v / 100;
        p -= 2;
        memcpy(p, PAIRS.t + 2 * (v - q * 100), 2);
        v = q;
    }
    if (v >= 10) {
        p -= 2;
        memcpy(p, PAIRS.t + 2 * v, 2);
    } else {
        *--p = char('0' + v);
    }
    int n = int(buf + 20 - p);
    memcpy(w, p, n);
    return n;
}

// "%lld" of v, INT64_MIN included.
inline int write_i64(char* w, int64_t v) {
    if (v < 0) {
        *w = '-';
        return 1 + write_u64(w + 1, 0 - uint64_t(v));
    }
    return write_u64(w, uint64_t(v));
}

// "%.6g" of f widened to double for 0 and 1e-3 <= |f| < 1e9; -1 (nothing
// written) for every other value. |f| = m * 2^e with m < 2^24; q, the
// six significant digits, is |f| * 10^(5 - x) rounded half to even, found
// with one divide (a shift when the divisor is a power of two): m * 10^k
// < 2^54 and the divisor is at most 2^34 or 2^4 * 10^4. x, the decimal
// exponent, lies in [-3, 9], so %g's e style (x < -4 or x >= 6) is
// always e+0x.
inline int write_score_fast(char* w, float f) {
    double a = std::fabs(double(f));
    if (a != 0.0 && !(a >= 1e-3 && a < 1e9)) return -1;  // NaN too
    uint32_t bits;
    memcpy(&bits, &f, sizeof(bits));
    char* s = w;
    if (bits >> 31) *w++ = '-';
    if (a == 0.0) {
        *w++ = '0';
        return int(w - s);
    }
    uint64_t m = (bits & 0x7FFFFFu) | 0x800000u;  // no subnormal is in range
    int e = int((bits >> 23) & 0xFF) - 150;
    int x = ((e + 23) * 1233) >> 12;   // floor(log10 2^(e+23)): X or X - 1
    uint64_t q, r, den;
    for (;;) {
        int k = 5 - x;
        uint64_t num = m;
        int sh = 0;
        if (e >= 0) num <<= e; else sh = -e;
        if (k >= 0) {
            num *= POW10[k];
            q = num >> sh;
            den = 1ull << sh;
            r = num - (q << sh);
        } else {
            den = POW10[-k] << sh;
            q = num / den;
            r = num - q * den;
        }
        if (q >= 1000000) ++x;
        else if (q < 100000) --x;
        else break;
    }
    if (2 * r > den || (2 * r == den && (q & 1))) ++q;
    if (q == 1000000) {
        q = 100000;
        ++x;
    }
    while (q % 10 == 0) q /= 10;       // %g drops trailing zeros
    char dg[8];
    int nd = write_u64(dg, q);
    if (x >= 6) {                      // d.ddddde+0x: -3 <= x <= 9 here
        *w++ = dg[0];
        if (nd > 1) {
            *w++ = '.';
            memcpy(w, dg + 1, nd - 1);
            w += nd - 1;
        }
        memcpy(w, "e+0", 3);
        w += 3;
        *w++ = char('0' + x);
    } else if (x >= 0) {               // x + 1 digits before the point
        int ip = x + 1;
        if (nd <= ip) {
            memcpy(w, dg, nd);
            memset(w + nd, '0', ip - nd);
            w += ip;
        } else {
            memcpy(w, dg, ip);
            w += ip;
            *w++ = '.';
            memcpy(w, dg + ip, nd - ip);
            w += nd - ip;
        }
    } else {                           // 0.000ddd
        *w++ = '0';
        *w++ = '.';
        memset(w, '0', -x - 1);
        w += -x - 1;
        memcpy(w, dg, nd);
        w += nd;
    }
    return int(w - s);
}

// "%.6g" of f widened to double: the integer path, else snprintf, counted
// in *slow.
inline int write_score(char* w, float f, int64_t* slow) {
    int n = write_score_fast(w, f);
    if (n >= 0) return n;
    ++*slow;
    return snprintf(w, 32, "%.6g", (double)f);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Output record formatting (matchUniqueImplementation.cpp:265-291 layout):
//   read_id \t seq[matched orientation] \t [score] \t 1 \t a \t patl \t
//   +/- \t fragment_id \t 1-based-local-pos \t <empty> \t k \n
// The score column is C++ `ostream << float` = "%.6g" of the float32
// widened to double. Returns bytes written, or -1 if out_cap would be
// exceeded (caller sizes out with format_records_bound, so this is a
// programming error, not a runtime path). *score_slow is set to the
// number of scores that snprintf wrote.
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
        uint8_t* out, int64_t out_cap,
        int64_t* score_slow) {
    static const char FWD[5] = {'A', 'C', 'G', 'T', 'N'};
    static const char REV[5] = {'T', 'G', 'C', 'A', 'N'};
    uint8_t* w = out;
    uint8_t* lim = out + out_cap;
    *score_slow = 0;
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
            w += write_score((char*)w, score[i], score_slow);
            *w++ = '\t';
        } else {
            *w++ = '\t';  // empty score column
        }
        *w++ = '1'; *w++ = '\t'; *w++ = 'a'; *w++ = '\t';
        w += write_i64((char*)w, sl);
        *w++ = '\t';
        *w++ = inv[i] ? '-' : '+';
        *w++ = '\t';
        memcpy(w, name_blob + name_off[nmi], nml);
        w += nml;
        *w++ = '\t';
        w += write_i64((char*)w, local_pos[i]);
        *w++ = '\t';
        *w++ = '\t';  // empty type column
        w += write_i64((char*)w, errs[i]);
        *w++ = '\n';
    }
    return w - out;
}

// Checks of the number writers. format_int: "%lld" of v. format_scores:
// each score's "%.6g" and a newline, *score_slow as format_records sets
// it (out holds 32 bytes a score). format_score_check: every float32 bit
// pattern lo, lo + stride, ... below hi whose score takes the integer
// path, against snprintf's bytes; returns the patterns that differ and
// sets *checked to the patterns compared.
int64_t format_int(int64_t v, uint8_t* out) {
    return write_i64((char*)out, v);
}

int64_t format_scores(int64_t n, const float* score, uint8_t* out,
                      int64_t* score_slow) {
    uint8_t* w = out;
    *score_slow = 0;
    for (int64_t i = 0; i < n; ++i) {
        w += write_score((char*)w, score[i], score_slow);
        *w++ = '\n';
    }
    return w - out;
}

int64_t format_score_check(uint64_t lo, uint64_t hi, uint64_t stride,
                           int64_t* checked) {
    int64_t bad = 0, seen = 0;
    for (uint64_t b = lo; b < hi; b += stride) {
        uint32_t bits = uint32_t(b);
        float f;
        memcpy(&f, &bits, sizeof(f));
        char fast[32], slow[32];
        int n = write_score_fast(fast, f);
        if (n < 0) continue;
        ++seen;
        int m = snprintf(slow, sizeof(slow), "%.6g", (double)f);
        bad += n != m || memcmp(fast, slow, n) != 0;
    }
    *checked = seen;
    return bad;
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
