"""The comparison's exact counts, its draw of compared rows and its
verdict, on hand-made labels."""

from __future__ import annotations

import numpy as np

from benchmark.core import compare

BINS, ACC, CAP = [0.0, 0.01, 0.1, 1.0], [1e-4, 1e-3, 1e-2], 4_000_000


def labeled(cp, n, done, bad=0):
    return compare.Labeled(cp=np.asarray(cp, np.float32), n=np.asarray(n),
                           converged=np.asarray(done), rows_bad=bad,
                           robot_verts=None, geometry=None)


def test_rows_bad_counts_labels_that_are_no_count_over_n():
    lab = labeled([0.5, 0.5, 1 / 3, 1.5, np.nan, 0.0], [10_000, 10_001, 30_000, 10, 10, 0],
                  [True] * 6, bad=7)
    # 0.5 of 10,001 is no whole count; 1.5 and nan out of range; n = 0
    assert compare.rows_bad(lab, CAP) == 7 + 4


def test_stop_faults():
    lab = labeled([0.5, 0.5, 0.0, 0.0, 0.002],
                  [10_000, 9_000, 37_000, 1_000, CAP], [True, True, True, False, False])
    # 9,000 at 0.5 claims done but its slack is 1.03e-2; 1,000 stopped undone
    assert compare.stop_faults(lab, BINS, ACC, CAP) == 2


def test_sample_draws_distinct_rows_with_the_most_sampled():
    n = np.arange(10_000)
    lab = labeled(np.zeros(10_000), n, np.ones(10_000, bool))
    idx = compare.sample(lab, 5, 2048, 64)
    assert len(idx) == len(set(idx.tolist())) == 2048
    assert set(range(10_000 - 64, 10_000)) <= set(idx.tolist())
    assert abs(np.mean(idx[idx < 10_000 - 64]) - 4968) < 300  # no lean to early rows
    assert np.array_equal(idx, compare.sample(lab, 5, 2048, 64))


def test_label_stats_and_verdict():
    p = np.array([0.5, 0.05, 0.005, 0.0])
    n = np.array([10_000, 200_000, 2_000_000, 40_000])
    exact_labels = compare.label_stats(p, n, p, BINS, ACC)
    assert exact_labels == (0.0, 0.0)
    miss, z2 = compare.label_stats(p + [0.02, 0.0, 0.0, 0.0], n, p, BINS, ACC)
    # z^2 = 0.02^2 / (0.25 / 10,000) = 16 on one of the three rows in the band;
    # the certain row (p = 0, cp = 0) counts in neither
    assert miss == 1 / 3 and abs(z2 - 16 / 3) < 1e-9
    ok, checks = compare.verdict({"miss_share": 0.05, "z2_mean": 7.0},
                                 {"miss_share": 0.12, "z2_mean": 6.0})
    assert not ok and checks["z2_mean"] == {"value": 7.0, "limit": 6.0}
