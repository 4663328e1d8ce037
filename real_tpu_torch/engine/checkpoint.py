"""Checkpoint/resume for matchUnique and matchAll (counterpart of
real_tpu/engine/checkpoint.py).

The reference never wrote checkpoints, but its architecture is restartable
by design: the per-read uniqueinfo array is the ONLY state carried across
index blocks (matchUniqueImplementation.cpp:1097), and blocks are
independent given it. Here the analogous state is the per-batch MatchState
(matchAll: the accumulated hit columns) plus the (file, shard) unit cursor;
both go to one .npz after completed units, and a restart skips the
completed units (their index builds too) and restores the state.

The file holds numpy arrays only, so one written by a CPU run loads on the
card and the other way round. The fingerprint ties a checkpoint to the
exact work decomposition: config fields that affect results or batching,
input file identities, and the unit/batch counts. A stale, mismatched or
unreadable checkpoint is ignored with a message.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import zipfile
from typing import List, Optional

import numpy as np

_FIELDS = ("st", "pos", "frag", "fileid", "errs", "score")
# what np.load and the key lookups raise on a torn or foreign file
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _file_stamp(path: str):
    """(size, mtime_ns) of an input file — editing a file in place while
    keeping its name and read count must invalidate the checkpoint."""
    try:
        st = os.stat(path)
    except OSError:
        return [0, 0]
    return [st.st_size, st.st_mtime_ns]


def fingerprint(cfg, texts, num_reads: int, num_batches: int,
                cand_cap: int, survivor_cap: int) -> str:
    ident = {
        "cfg": [cfg.seedl, cfg.seedkmax, cfg.totalkmax, cfg.scores,
                cfg.filter_level, cfg.batch_size, cfg.index_shards,
                cfg.similarity, cfg.err, cfg.trans, cfg.gc,
                cfg.gcmut_bias],
        "caps": [cand_cap, survivor_cap],
        "texts": [(t.name, int(t.packed.n)) for t in texts],
        "textfile": _file_stamp(cfg.textfilename),
        "reads": [cfg.patternfilename, num_reads, num_batches],
        "readfile": _file_stamp(cfg.patternfilename),
    }
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()


class _NpzCheckpoint:
    """One .npz file tied to a fingerprint: atomic save, guarded load."""

    def __init__(self, path: str, fp: str):
        self.path = path
        self.fp = fp

    def _read(self, decode) -> Optional[dict]:
        """decode(npz) of the file, or None (with a message) when it is
        absent, of another fingerprint or unreadable."""
        if not self.path or not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                if str(z["fingerprint"]) != self.fp:
                    print("checkpoint fingerprint mismatch; ignoring it",
                          file=sys.stderr)
                    return None
                return decode(z)
        except _UNREADABLE as e:   # e.g. a file cut off mid-write
            print(f"checkpoint unreadable ({e}); ignoring it",
                  file=sys.stderr)
            return None

    def _write(self, payload: dict) -> None:
        """Atomic write (tmp + rename): a kill mid-save leaves the old or
        the new checkpoint, never a torn one."""
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fobj:
            np.savez(fobj, fingerprint=self.fp, **payload)
        os.replace(tmp, self.path)

    def delete(self) -> None:
        if self.path and os.path.exists(self.path):
            os.remove(self.path)


class Checkpoint(_NpzCheckpoint):
    """matchUnique: (per-batch MatchState, reduced overflow, unit cursor)."""

    def load(self) -> Optional[dict]:
        """{units_done, states: [dict], overflow: [array]} or None."""
        def decode(z):
            nb = int(z["num_batches"])
            return {"units_done": int(z["units_done"]),
                    "states": [{f: z[f"b{bi}_{f}"] for f in _FIELDS}
                               for bi in range(nb)],
                    "overflow": [z[f"b{bi}_overflow"] for bi in range(nb)]}
        return self._read(decode)

    def save(self, units_done: int, states: List[dict],
             overflow: List[np.ndarray]) -> None:
        payload = {"units_done": np.int64(units_done),
                   "num_batches": np.int64(len(states))}
        for bi, (st, of) in enumerate(zip(states, overflow)):
            for f in _FIELDS:
                payload[f"b{bi}_{f}"] = st[f]
            payload[f"b{bi}_overflow"] = of
        self._write(payload)


_HIT_COLS = ("pid", "k", "pos", "fid", "frag", "score", "inv")


class AllCheckpoint(_NpzCheckpoint):
    """matchAll: (accumulated hit columns, per-read overflow, unit
    cursor). Hits of completed units are independent of later units (index
    shards are disjoint window ranges), so resuming replays only the
    unfinished units."""

    def load(self) -> Optional[dict]:
        def decode(z):
            return {"units_done": int(z["units_done"]),
                    "overflow": z["overflow"],
                    "cols": tuple(z[f"hit_{c}"] for c in _HIT_COLS)}
        return self._read(decode)

    def save(self, units_done: int, overflow: np.ndarray,
             cols: tuple) -> None:
        payload = {"units_done": np.int64(units_done), "overflow": overflow}
        for name, col in zip(_HIT_COLS, cols):
            payload[f"hit_{name}"] = col
        self._write(payload)
