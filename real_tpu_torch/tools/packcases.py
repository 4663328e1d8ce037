"""Crafted texts for the genome pack (ops/pack.py): the edges of its
words, its N bitmap and its all-T flags, each with the flags it must give.

The CPU tests hold real_tpu's pack to these flags and the port's
pack_tables_ref to real_tpu; chip_smoke.py and the card's tests hold the
kernel (csrc/pack_text.cu) to pack_tables_ref on every one of them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class PackCase(NamedTuple):
    name: str
    codes: np.ndarray                    # uint8 base codes, 0..4
    # (has_n, allt32, allt64) the text must give; None: not crafted for
    flags: Optional[Tuple[bool, bool, bool]]


def _acg(rng, n: int) -> np.ndarray:
    """n bases of A, C and G: no T, so no all-T segment, and no N."""
    return rng.integers(0, 3, n).astype(np.uint8)


def _with_t(rng, n: int, runs) -> np.ndarray:
    codes = _acg(rng, n)
    for start, length in runs:
        codes[start:start + length] = 3
    return codes


def crafted_texts(seed: int = 7) -> List[PackCase]:
    """The crafted texts: lengths around the 16- and 32-base words, N runs
    across word edges, all-T segment pairs that set the seedl 32 flag
    alone, both flags (a pair of 16-base segments is also a pair of
    8-base ones, so the seedl 64 flag never comes alone) or neither, and
    pairs in the text's last window."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (0, 1, 15, 16, 17, 31, 33, 1000):
        c = rng.integers(0, 5, n).astype(np.uint8)
        out.append(PackCase(f"random_{n}", c, None))
        out.append(PackCase(f"all_t_{n}", np.full(n, 3, np.uint8),
                            (False, n >= 32, n >= 64)))
        out.append(PackCase(f"all_n_{n}", np.full(n, 4, np.uint8),
                            (n > 0, False, False)))
    c = _acg(rng, 1000)
    for start, length in ((13, 6), (30, 5), (63, 2), (95, 34), (500, 1),
                          (511, 2), (990, 10)):
        c[start:start + length] = 4
    out.append(PackCase("n_runs_across_word_edges", c, (True, False, False)))
    # seedl 32: segments of 8 at +0, +8, +16, +24 of a window
    out.append(PackCase("allt32_only_gap16",
                        _with_t(rng, 300, [(100, 8), (116, 8)]),
                        (False, True, False)))
    out.append(PackCase("allt32_only_gap24",
                        _with_t(rng, 300, [(7, 8), (31, 8)]),
                        (False, True, False)))
    # seedl 64: segments of 16 at +0, +16, +32, +48
    out.append(PackCase("allt64_gap48",
                        _with_t(rng, 400, [(101, 16), (149, 16)]),
                        (False, True, True)))
    out.append(PackCase("all_t_none_gap32",
                        _with_t(rng, 400, [(40, 8), (80, 8), (121, 7),
                                           (129, 7)]),
                        (False, False, False)))
    out.append(PackCase("all_t_none_7_runs",
                        _with_t(rng, 400, [(s, 7) for s in range(0, 392, 8)]),
                        (False, False, False)))
    # the text's last window: segments 0 and 3 of its last start
    out.append(PackCase("allt32_last_window",
                        _with_t(rng, 333, [(333 - 32, 8), (333 - 8, 8)]),
                        (False, True, False)))
    out.append(PackCase("allt64_last_window",
                        _with_t(rng, 333, [(333 - 64, 16), (333 - 16, 16)]),
                        (False, True, True)))
    # a pair one base too long for the text: no window holds both
    out.append(PackCase("allt32_past_the_end",
                        _with_t(rng, 40, [(9, 8), (33, 7)]),
                        (False, False, False)))
    out.append(PackCase("allt64_short_text",
                        _with_t(rng, 63, [(0, 16), (47, 16)]),
                        (False, True, False)))
    return out
