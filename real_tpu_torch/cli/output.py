"""Byte-identical output record formatting.

Record layout (matchUniqueImplementation.cpp:265-291,
matchAllImplementation.cpp:481-517), tab separated:

  read_id  seq[matched orientation]  [score]  1  a  patl  +/-  fragment_id
  1-based-position-in-fragment  <empty>  num_mismatches

Scores are printed as C++ `ostream << float` (general format, 6 significant
digits) == Python '%.6g' of the float32 value widened to double.

Records are formatted by the native C++ formatter (native/readpack.cpp
format_records) in bounded chunks through two formatter threads and a
writer thread. The vectorized NumPy formatter, _format_records_plain, is
its plain version: it serves use_native=False and read sets whose ids are a
list of strings and not an IdView blob.
"""

from __future__ import annotations

import collections
import ctypes
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import IO, Callable, Dict, List, Tuple

import numpy as np

from real_tpu_torch import native
from real_tpu_torch.engine.driver import HIT_DTYPES, MatchResult, TextFile
from real_tpu_torch.engine.matchstep import REVERSE, STRAIGHT
from real_tpu_torch.io.reads import IdView, ReadSet, reverse_complement
from real_tpu_torch.utils import spans

_REMAP = np.frombuffer(b"ACGTN", dtype=np.uint8)
_CHUNK_RECORDS = 1 << 18


def _write_bytes(out: IO, blob: bytes) -> None:
    buf = getattr(out, "buffer", None)
    if buf is not None:
        buf.write(blob)
    else:
        try:
            out.write(blob)
        except TypeError:
            out.write(blob.decode("latin-1"))


def _frag_tables(texts: List[TextFile]):
    """Per-file (names S-array, offsets int64 array) lookup tables."""
    names, offs = [], []
    for tf in texts:
        r = tf.packed.ranges
        names.append(np.array([nm.encode("latin-1") for nm, _ in r]))
        offs.append(np.array([off for _, off in r], dtype=np.int64))
    return names, offs


def _seq_column(codes_mat: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """[n, L] codes + strand -> S-array of sequence strings in matched
    orientation (reverse complement for '-' hits)."""
    n, L = codes_mat.shape
    rc = reverse_complement(codes_mat)
    sel = np.where(inv[:, None], rc, codes_mat)
    return np.frombuffer(_REMAP[sel].tobytes(), dtype=f"S{L}")


def _gather_codes(rs: ReadSet, pids: np.ndarray, L: int) -> np.ndarray:
    idx = (rs.offsets[pids][:, None]
           + np.arange(L, dtype=np.int64)[None, :])
    return rs.codes_flat[idx]


def _int_col(a: np.ndarray) -> np.ndarray:
    return np.char.mod(b"%d", a.astype(np.int64))


def _score_col(a: np.ndarray) -> np.ndarray:
    return np.char.mod(b"%.6g", a.astype(np.float32).astype(np.float64))


def _join_records(cols: List[np.ndarray]) -> bytes:
    """Tab-join byte columns into newline-terminated records."""
    tab = np.array(b"\t")
    rec = cols[0]
    for c in cols[1:]:
        rec = np.char.add(np.char.add(rec, tab), c)
    if len(rec) == 0:
        return b""
    return b"\n".join(rec.tolist()) + b"\n"


def _global_frag_tables(texts: List[TextFile]):
    """Fragment names of all files as one blob: (name_blob uint8, name_off
    int64 [F+1], file_base int64 per file, frag_start int64 aligned with
    the global name index)."""
    parts, starts, bases = [], [], []
    for tf in texts:
        r = tf.packed.ranges
        bases.append(len(parts))
        for nm, off in r[:-1]:
            parts.append(nm.encode("latin-1"))
            starts.append(off)
    name_off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(b) for b in parts], out=name_off[1:])
    blob = np.frombuffer(b"".join(parts), np.uint8)
    return (blob, name_off, np.asarray(bases, np.int64),
            np.asarray(starts, np.int64))


def _format_records_native(rs: ReadSet, pids, inv, fileid, frag, pos, errs,
                           score, texts: List[TextFile],
                           scores: bool) -> bytes:
    """Record lines from the C++ formatter; rs.ids must be an IdView. The
    f64 scores of the engine are narrowed to float32 here, where
    _score_col narrows them for the plain version."""
    lib = native.get_lib()
    ids = rs.ids
    blob, name_off, file_base, frag_start = _global_frag_tables(texts)
    name_idx = file_base[fileid.astype(np.int64)] + frag.astype(np.int64)
    # the C code indexes with these unchecked
    if (pids.min() < 0 or pids.max() >= len(ids) or name_idx.min() < 0
            or name_idx.max() >= len(frag_start)):
        raise ValueError("format_records: read or fragment index out of "
                         "range")
    local_pos = pos.astype(np.int64) - frag_start[name_idx] + 1

    def arr(a, dtype):
        return np.ascontiguousarray(a, dtype)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = pids.size
    pid64, ni, lp = (arr(a, np.int64) for a in (pids, name_idx, local_pos))
    id_off, code_off = arr(ids.off, np.int64), arr(rs.offsets, np.int64)
    id_blob, codes = arr(ids.blob, np.uint8), arr(rs.codes_flat, np.uint8)
    inv8, errs32 = arr(inv, np.uint8), arr(errs, np.int32)
    sc = arr(score, np.float32) if scores else None
    i64 = ctypes.c_int64
    cap = lib.format_records_bound(n, p(pid64, i64), p(id_off, i64),
                                   p(code_off, i64), p(ni, i64),
                                   p(name_off, i64))
    out = np.empty(int(cap), np.uint8)
    written = lib.format_records(
        n, p(id_blob, ctypes.c_uint8), p(id_off, i64),
        p(codes, ctypes.c_uint8), p(code_off, i64), p(pid64, i64),
        p(inv8, ctypes.c_uint8),
        p(sc, ctypes.c_float) if scores
        else ctypes.POINTER(ctypes.c_float)(),
        p(blob, ctypes.c_uint8), p(name_off, i64), p(ni, i64), p(lp, i64),
        p(errs32, ctypes.c_int32), p(out, ctypes.c_uint8), out.size)
    if written < 0:
        raise RuntimeError("format_records overran the buffer sized by "
                           "format_records_bound")
    return out[:written].tobytes()


def _format_records(rs: ReadSet, pids: np.ndarray, inv: np.ndarray,
                    fileid: np.ndarray, frag: np.ndarray, pos: np.ndarray,
                    errs: np.ndarray, score: np.ndarray,
                    texts: List[TextFile], scores: bool,
                    use_native: bool = True) -> bytes:
    """Record lines for hits (pids may repeat for matchAll), emitted in
    the given order."""
    if pids.size == 0:
        return b""
    fmt = (_format_records_native
           if use_native and isinstance(rs.ids, IdView)
           else _format_records_plain)
    return fmt(rs, pids, inv, fileid, frag, pos, errs, score, texts, scores)


def _format_records_plain(rs: ReadSet, pids: np.ndarray, inv: np.ndarray,
                          fileid: np.ndarray, frag: np.ndarray,
                          pos: np.ndarray, errs: np.ndarray,
                          score: np.ndarray, texts: List[TextFile],
                          scores: bool) -> bytes:
    """The plain version: vectorized NumPy record lines."""
    names, offs = _frag_tables(texts)
    n = pids.size

    ids = rs.ids
    if hasattr(ids, "bytes_at"):
        id_col = np.array([ids.bytes_at(p) for p in pids.tolist()])
    else:
        id_col = np.array([ids[p].encode("latin-1") for p in pids.tolist()])

    seq_col = np.empty(n, dtype=object)
    lens = rs.lengths[pids]
    for L in np.unique(lens):
        m = lens == L
        seq_col[m] = _seq_column(_gather_codes(rs, pids[m], int(L)), inv[m])

    frag_name = np.empty(n, dtype=object)
    local_pos = np.empty(n, dtype=np.int64)
    for fi in np.unique(fileid):
        m = fileid == fi
        frag_name[m] = names[fi][frag[m]]
        local_pos[m] = pos[m].astype(np.int64) - offs[fi][frag[m]] + 1

    score_col = (_score_col(score) if scores
                 else np.full(n, b"", dtype="S1"))
    strand = np.where(inv, np.array(b"-"), np.array(b"+"))
    ones = np.full(n, b"1", dtype="S1")
    a_col = np.full(n, b"a", dtype="S1")
    empty = np.full(n, b"", dtype="S1")

    return _join_records([
        id_col, seq_col.astype(bytes), score_col, ones, a_col,
        _int_col(lens), strand, frag_name.astype(bytes),
        _int_col(local_pos), empty, _int_col(errs)])


def _emit_chunks(out: IO, make_blob: Callable[[int, int], bytes], n: int,
                 chunk: int = _CHUNK_RECORDS) -> None:
    """Stream n formatted records in bounded chunks through two formatter
    threads and a writer thread (the reference's AsynchronousWriter.hpp).
    The native formatter is a ctypes call that releases the interpreter
    lock, so two chunks format at once while the writer overlaps the
    file, and the host holds a bounded number of chunk blobs instead of
    the whole output. Blob order is the submit order. Each chunk's
    formatting is a span `output.format` and each write a span
    `output.write`, children of the caller's span on whichever thread
    runs them (utils/spans.py)."""
    at = spans.here()

    def fmt(s: int, e: int) -> bytes:
        with spans.span("output.format", at):
            return make_blob(s, e)

    def write(b: bytes) -> None:
        with spans.span("output.write", at):
            _write_bytes(out, b)

    if n <= chunk:
        write(fmt(0, n))
        return
    q: "queue.Queue" = queue.Queue(maxsize=2)
    failed: List[BaseException] = []

    def writer():
        while True:
            b = q.get()
            if b is None:
                return
            if not failed:
                try:
                    write(b)
                except Exception as e:      # re-raised by the caller below
                    failed.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            pending = collections.deque()
            for s in range(0, n, chunk):
                pending.append(ex.submit(fmt, s, min(s + chunk, n)))
                while len(pending) > 3:
                    q.put(pending.popleft().result())
            while pending:
                q.put(pending.popleft().result())
    finally:
        q.put(None)
        t.join()
    if failed:
        raise failed[0]


@spans.traced("output")
def write_unique(out: IO, rs: ReadSet, result: MatchResult,
                 texts: List[TextFile], scores: bool,
                 use_native: bool = True) -> int:
    """Final output pass in read order, in bounded chunks of records;
    returns the unique-hit count (printed as 'unique: N' by the CLI)."""
    pids = np.flatnonzero((result.st == STRAIGHT) | (result.st == REVERSE))

    def make_blob(s, e):
        p = pids[s:e]
        return _format_records(
            rs, p, result.st[p] == REVERSE, result.fileid[p],
            result.frag[p], result.pos[p], result.errs[p],
            result.score[p], texts, scores, use_native)

    _emit_chunks(out, make_blob, pids.size)
    return int(pids.size)


@spans.traced("output")
def write_all_arrays(out: IO, rs: ReadSet, cols, texts: List[TextFile],
                     scores: bool, use_native: bool = True) -> int:
    """matchAll output from sorted, deduped hit columns (pid, k, pos,
    fileid, frag, score, inv) — MatchAllResult.cols of
    driver.run_match_all(as_arrays=True) — in bounded chunks of records.
    The reference's order is thread-interleaved and nondeterministic
    (matchAllImplementation.cpp:467-533); this prints read-major, the hits
    of a read in unified (sorted) order, as real_tpu does. Returns the
    record count, which adds to the job's counter `allhits.records`."""
    pid, k, pos, fid, frag, score, inv = cols
    spans.add("allhits.records", len(pid))

    def make_blob(s, e):
        return _format_records(
            rs, pid[s:e], inv[s:e].astype(bool), fid[s:e].astype(np.int64),
            frag[s:e].astype(np.int64), pos[s:e], k[s:e], score[s:e],
            texts, scores, use_native)

    _emit_chunks(out, make_blob, len(pid))
    return int(len(pid))


def write_all(out: IO, rs: ReadSet, hits: Dict[int, List[Tuple]],
              texts: List[TextFile], scores: bool,
              use_native: bool = True) -> int:
    """matchAll output from the {patid: [(k, pos, fileid, frag, score,
    inverted), ...]} form of driver.run_match_all (small runs, tests)."""
    rows = [(pid,) + h for pid in sorted(hits) for h in hits[pid]]
    cols = [np.array([r[i] for r in rows], dtype=dt)
            for i, dt in enumerate(HIT_DTYPES)]
    return write_all_arrays(out, rs, tuple(cols), texts, scores, use_native)
