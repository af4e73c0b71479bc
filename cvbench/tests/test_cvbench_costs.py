"""The least-work counts of ``cvbench/costs.py`` against numbers worked by
hand for the four cells' shapes (float64, weighted, all four flags)."""

import pytest

from cvbench import costs

# Values a fold hands back: XTX and XTY, and the four statistics (2 (K + M)).
OUT_K500 = 500 * 510 + 2 * 510        # 256,020
OUT_K20K = 20_000 * 20_001 + 2 * 20_001  # 400,060,002


@pytest.mark.parametrize("shapes,k,m,out,nbytes,flops", [
    # LOOCV, N=100,000: 8 (255,000 + 1,021 + 100,000 x 511
    # + 100,000 x 256,020); 100,000 (500 x 501 + 2 x 500 x 10).
    ([(100_000, 1)], 500, 10, OUT_K500, 205_226_848_168, 26_050_000_000),
    # 10-fold at K=20,000: 8 (400,020,000 + 40,003 + 10 x 500 x 20,002
    # + 10 x 400,060,002); 10 (500 x 20,000 x 20,001 + 2 x 500 x 20,000).
    ([(10, 500)], 20_000, 1, OUT_K20K, 36_005_360_184, 2_000_300_000_000),
    # P=10,000, L=10: 8 (256,021 + 10,000 x 10 x 511 + 10,000 x 256,020);
    # 10,000 (10 x 250,500 + 2 x 10 x 5,000).
    ([(10_000, 10)], 500, 10, OUT_K500, 20_892_448_168, 26_050_000_000),
    # LOOCV reduced to colstats, 2 (K + M) = 1,020 values a fold.
    ([(100_000, 1)], 500, 10, 1_020, 1_226_848_168, 26_050_000_000),
])
def test_folds_cost(shapes, k, m, out, nbytes, flops):
    assert costs.folds_cost(shapes, k, m, 8, True, out) == (nbytes, flops)


def test_folds_cost_buckets_add_and_flops_drop():
    one = costs.folds_cost([(3, 4)], 7, 2, 8, True, 10)
    two = costs.folds_cost([(2, 4), (1, 4)], 7, 2, 8, True, 10)
    assert one == two
    assert costs.folds_cost([(3, 4)], 7, 2, 8, True, 10, False)[1] == 0


@pytest.mark.parametrize("n,k,m,nbytes,flops", [
    # 8 (100,000 x 511 + 255,000 + 1,021); 100,000 x 500 x 501
    # + 2 x 100,000 x 500 x 10.
    (100_000, 500, 10, 410_848_168, 26_050_000_000),
    # 8 (5,000 x 20,002 + 400,020,000 + 40,003); 5,000 x 20,000 x 20,001
    # + 2 x 5,000 x 20,000.
    (5_000, 20_000, 1, 4_000_560_024, 2_000_300_000_000),
])
def test_fit_cost(n, k, m, nbytes, flops):
    assert costs.fit_cost(n, k, m, 8, True) == (nbytes, flops)


def test_least_seconds():
    # LOOCV folds: bytes bound, 205.2 GB at 3.35 TB/s = 61.3 ms.
    t, which = costs.least_seconds(205_226_848_168, 26_050_000_000)
    assert which == "bytes" and t == pytest.approx(0.0612617, rel=1e-5)
    # Wide K folds: FLOPs bound, 2.0003e12 at 67 TFLOP/s = 29.86 ms.
    t, which = costs.least_seconds(36_005_360_184, 2_000_300_000_000)
    assert which == "flops" and t == pytest.approx(0.0298552, rel=1e-5)
