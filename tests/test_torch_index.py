"""The port's index build (real_tpu_torch/index/build.py) against
real_tpu's. `sig` and `bb` must be array-equal; `pos` equal up to a
permutation inside each run of equal signatures (the list order within an
equal signature is free, real_tpu/index/build.py:280-285). Exact."""

import numpy as np
import pytest

from real_tpu.engine import driver as j_driver
from real_tpu.index import build as j_build
from real_tpu.text import packed as j_packed
from real_tpu_torch.engine import driver as t_driver
from real_tpu_torch.index import build as t_build
from real_tpu_torch.text import packed as t_packed


def _genome(n, seed, n_prob=0.0, t_run=0, frags=1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if n_prob:
        codes[rng.random(n) < n_prob] = 4
    if t_run:
        codes[1000:1000 + t_run] = 3
    per = n // frags
    ranges = [(f"f{i}", i * per) for i in range(frags)] + [("terminal", n)]
    return codes, ranges


def assert_same_index(ji, ti):
    sig_j = np.asarray(ji.sig)
    sig_t = ti.sig.numpy().view(np.uint32)
    np.testing.assert_array_equal(sig_j, sig_t)
    np.testing.assert_array_equal(np.asarray(ji.bb), ti.bb.numpy())
    pos_j = np.asarray(ji.pos).reshape(6, -1)
    pos_t = ti.pos.numpy().reshape(6, -1)
    for j, (sj, pj, pt) in enumerate(zip(sig_j.reshape(6, -1), pos_j,
                                         pos_t)):
        oj = np.lexsort((pj, sj))
        ot = np.lexsort((pt, sj))
        np.testing.assert_array_equal(pj[oj], pt[ot], err_msg=f"list {j}")
    assert ji.bucket_bits == ti.bucket_bits


CASES = {
    # n, seed, n_prob, t_run, frags, start, num_windows, bucket_bits
    "histogram_with_n": (20000, 1, 0.003, 0, 3, 0, None, 0),
    "bisect_table": (40000, 2, 0.0, 0, 1, 0, None, 12),
    "all_t_sentinel_order": (20000, 3, 0.002, 48, 1, 0, None, 0),
    "all_t_bisect": (40000, 4, 0.0, 48, 1, 0, None, 12),
    "sub_range": (20000, 5, 0.001, 0, 2, 4096, 10000, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_index_equals_real_tpu(case):
    n, seed, n_prob, t_run, frags, start, nwin, bits = CASES[case]
    codes, ranges = _genome(n, seed, n_prob, t_run, frags)
    jt = j_packed.build_packed_text(codes, ranges)
    tt = t_packed.build_packed_text(codes, ranges, "cpu")
    assert jt.order_sentinels(32) == tt.order_sentinels(32) == bool(t_run)
    ji = j_build.build_index(jt, 32, start=start, num_windows=nwin,
                             bucket_bits=bits)
    ti = t_build.build_index(tt, 32, start=start, num_windows=nwin,
                             bucket_bits=bits)
    windows = nwin if nwin is not None else n - 32 + 1 - start
    route = t_build._use_bisect_table(ti.bucket_bits, windows)
    assert route == j_build._use_bisect_table(ji.bucket_bits, windows, False)
    assert route == (bits == 12)      # each table route is exercised
    assert_same_index(ji, ti)
    if t_run:   # real all-T entries exist and precede the sentinels
        sig = ti.sig.numpy().view(np.uint32).reshape(6, -1)[0]
        pos = ti.pos.numpy().reshape(6, -1)[0]
        allt = (sig == 0xFFFFFFFF) & (pos != 0x7FFFFFFF)
        assert allt.any()
        last_real = np.flatnonzero(pos != 0x7FFFFFFF).max()
        assert last_real == np.flatnonzero(allt).max()


@pytest.mark.parametrize("windows", [100, 20000, 4_600_000, 46_000_000])
@pytest.mark.parametrize("reads", [0, 300, 100_000])
def test_host_plan_math_equal(windows, reads):
    for cap in (25, 27):
        assert (t_build.pick_bucket_bits(32, windows, reads, cap=cap)
                == j_build.pick_bucket_bits(32, windows, reads, cap=cap))
    for bits in (12, 15, 23):
        for k in (2, 8, 128):
            assert (t_driver._bsearch_steps_static(windows, k, bits)
                    == j_driver._bsearch_steps_static(windows, k, bits))
