"""Evaluation metric tests (eval/metrics.py, eval/accuracy_model.py)."""

import numpy as np

from spmv_topk.eval import metrics
from spmv_topk.eval.accuracy_model import (
    closed_form_precision, monte_carlo_precision,
)


def test_precision():
    assert metrics.precision_at_k([1, 2, 3, 4], [4, 3, 2, 1]) == 1.0
    assert metrics.precision_at_k([1, 2, 3, 4], [1, 2, 9, 8]) == 0.5


def test_ndcg_identity_and_disjoint():
    g = list(range(10))
    assert abs(metrics.ndcg(g, g) - 1.0) < 1e-12
    assert metrics.ndcg(g, list(range(100, 110))) == 0.0
    swapped = g.copy()
    swapped[0], swapped[1] = swapped[1], swapped[0]
    assert 0.9 < metrics.ndcg(g, swapped) < 1.0


def test_kendall_tau():
    g = [1, 2, 3, 4, 5]
    assert metrics.kendall_tau(g, g) > 0.999
    assert metrics.kendall_tau(g, g[::-1]) < 0


def test_edit_distance():
    assert metrics.edit_distance([1, 2, 3], [1, 2, 3]) == 0
    assert metrics.edit_distance([1, 2, 3], [1, 9, 3]) == 1
    assert metrics.edit_distance([1, 2], [3, 4, 5]) == 3


def test_bounded():
    g = list(range(50))
    out = metrics.bounded(metrics.precision_at_k, g, g, bounds=(10, 20, 50, 100))
    assert out == [1.0, 1.0, 1.0]  # 100 > len -> stops


def test_mean_stdev_warmup_skip():
    v = [100.0, 100.0, 1.0, 1.0, 1.0]
    assert metrics.mean(v, skip=2) == 1.0
    assert metrics.st_dev(v, skip=2) == 0.0


def test_accuracy_model_closed_form_vs_monte_carlo():
    """Reproduces the topk_errors.py validation: the closed form tracks the
    Monte-Carlo estimate of partitioned Top-K precision."""
    n, b, partition_k = 20000, 16, 8
    for k in (8, 50, 100):
        cf = closed_form_precision(n, b, k, partition_k)
        mc = monte_carlo_precision(n, b, k, partition_k, num_tests=5, seed=1)
        assert abs(cf - mc) < 0.1, (k, cf, mc)
    # k <= partition_k is always exact
    assert closed_form_precision(n, b, 8, 8) == 1.0


def test_accuracy_model_lane_partitioning_is_safe():
    """The sweep's effective partition count (128 lanes) keeps
    precision ~1 at K=100 with lane_k=8 — the design claim behind
    keeping only 8 candidates per lane."""
    assert closed_form_precision(100000, 128, 100, 8) > 0.999


def test_rescore_pool_convergence_model():
    """The serving-pipeline Monte-Carlo (plot_convergence.py analog):
    precision converges in the rescore-pool size, noise only hurts small
    pools, and with zero noise + full pool it matches the pure
    partition-survival model."""
    from spmv_topk.eval.accuracy_model import (
        monte_carlo_rescore_precision)

    n, b, k, pk = 20000, 16, 50, 8
    clean = [monte_carlo_rescore_precision(n, b, k, pk, pool, 0.0,
                                           num_tests=5, seed=3)
             for pool in (k, 4 * k)]
    assert clean[1] >= clean[0]
    # zero noise + pool covering every survivor == plain partitioned MC
    full = monte_carlo_rescore_precision(n, b, k, pk, b * pk, 0.0,
                                         num_tests=5, seed=1)
    plain = monte_carlo_precision(n, b, k, pk, num_tests=5, seed=1)
    assert abs(full - plain) < 1e-9
    # heavy noise with a k-sized pool loses precision; a wide pool
    # recovers it (the design argument for rescore_pool=4k)
    noisy_small = monte_carlo_rescore_precision(n, b, k, pk, k, 0.05,
                                                num_tests=5, seed=4)
    noisy_wide = monte_carlo_rescore_precision(n, b, k, pk, 8 * k, 0.05,
                                               num_tests=5, seed=4)
    assert noisy_wide > noisy_small
