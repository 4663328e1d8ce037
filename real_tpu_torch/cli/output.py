"""Byte-identical output record formatting (NumPy).

Record layout (matchUniqueImplementation.cpp:265-291,
matchAllImplementation.cpp:481-517), tab separated:

  read_id  seq[matched orientation]  [score]  1  a  patl  +/-  fragment_id
  1-based-position-in-fragment  <empty>  num_mismatches

Scores are printed as C++ `ostream << float` (general format, 6 significant
digits) == Python '%.6g' of the float32 value widened to double.
"""

from __future__ import annotations

from typing import IO, Dict, List, Tuple

import numpy as np

from real_tpu_torch.engine.driver import HIT_DTYPES, MatchResult, TextFile
from real_tpu_torch.engine.matchstep import REVERSE, STRAIGHT
from real_tpu_torch.io.reads import ReadSet, reverse_complement

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


def _format_records(rs: ReadSet, pids: np.ndarray, inv: np.ndarray,
                    fileid: np.ndarray, frag: np.ndarray, pos: np.ndarray,
                    errs: np.ndarray, score: np.ndarray,
                    texts: List[TextFile], scores: bool) -> bytes:
    """Vectorized record lines for hits, emitted in the given order."""
    if pids.size == 0:
        return b""
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


def write_unique(out: IO, rs: ReadSet, result: MatchResult,
                 texts: List[TextFile], scores: bool) -> int:
    """Final output pass in read order, in bounded chunks of records;
    returns the unique-hit count (printed as 'unique: N' by the CLI)."""
    pids = np.flatnonzero((result.st == STRAIGHT) | (result.st == REVERSE))
    for s in range(0, pids.size, _CHUNK_RECORDS):
        p = pids[s:s + _CHUNK_RECORDS]
        _write_bytes(out, _format_records(
            rs, p, result.st[p] == REVERSE, result.fileid[p],
            result.frag[p], result.pos[p], result.errs[p],
            result.score[p], texts, scores))
    return int(pids.size)


def write_all_arrays(out: IO, rs: ReadSet, cols, texts: List[TextFile],
                     scores: bool) -> int:
    """matchAll output from sorted, deduped hit columns (pid, k, pos,
    fileid, frag, score, inv) — MatchAllResult.cols of
    driver.run_match_all(as_arrays=True) — in bounded chunks of records.
    The reference's order is thread-interleaved and nondeterministic
    (matchAllImplementation.cpp:467-533); this prints read-major, the hits
    of a read in unified (sorted) order, as real_tpu does. Returns the
    record count."""
    pid, k, pos, fid, frag, score, inv = cols
    for s in range(0, len(pid), _CHUNK_RECORDS):
        e = s + _CHUNK_RECORDS
        _write_bytes(out, _format_records(
            rs, pid[s:e], inv[s:e].astype(bool), fid[s:e].astype(np.int64),
            frag[s:e].astype(np.int64), pos[s:e], k[s:e], score[s:e],
            texts, scores))
    return int(len(pid))


def write_all(out: IO, rs: ReadSet, hits: Dict[int, List[Tuple]],
              texts: List[TextFile], scores: bool) -> int:
    """matchAll output from the {patid: [(k, pos, fileid, frag, score,
    inverted), ...]} form of driver.run_match_all (small runs, tests)."""
    rows = [(pid,) + h for pid in sorted(hits) for h in hits[pid]]
    cols = [np.array([r[i] for r in rows], dtype=dt)
            for i, dt in enumerate(HIT_DTYPES)]
    return write_all_arrays(out, rs, tuple(cols), texts, scores)
