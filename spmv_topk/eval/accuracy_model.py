"""Closed-form accuracy model for partitioned approximate Top-K.

Port of the analytical model in
/root/reference/src/resources/python/topk_errors.py:29-42, which justifies
keeping only K'=8 results per partition: the probability that the global
Top-k survives p partitions each retaining partition_k candidates.

In the sweep the "partitions" are lanes x devices: each device keeps
lane_k candidates in each of its 128 SELL lanes, so the effective
partition count is 128 * num_devices — far higher than the FPGA's 32,
which is why recall at K=100 with lane_k=8 is essentially 1 (see
test_lane_k_approximation_recall)."""

from __future__ import annotations

from fractions import Fraction
from math import comb

import numpy as np


def closed_form_single_k(n: int, b: int, k: int, partition_k: int) -> float:
    """P(item of global rank <= k survives), topk_errors.py:29-38."""
    if k <= partition_k:
        return 1.0
    if partition_k * b < k:
        return 0.0
    denom = comb(n, k)
    delta = 0
    for i in range(partition_k + 1, min(n // b, k)):
        delta += comb(n // b, i)
    return float(1 - Fraction(b * delta, denom))


def closed_form_precision(n: int, b: int, k: int, partition_k: int) -> float:
    """Expected precision@k, averaged over ranks (topk_errors.py:41-42)."""
    return float(np.mean([
        closed_form_single_k(n, b, k_i, partition_k) for k_i in range(1, k + 1)
    ]))


def monte_carlo_rescore_precision(
    n: int, b: int, k: int, partition_k: int, pool: int,
    noise_sigma: float = 0.0, num_tests: int = 10, seed: int | None = 0,
) -> float:
    """Monte-Carlo precision@k of the full serving pipeline: partitioned
    survival (b partitions keeping partition_k each) under score noise
    (the reduced-precision codec's quantization, cf. the reference's
    FIXED_WIDTH sweep, types.hpp:20-27), then exact re-ranking of the
    top-`pool` noisy candidates (`config.rescore_pool`).

    This is the model behind the convergence figure: as `pool` (or
    partition_k) grows, precision converges to the partition-survival
    ceiling; noise only hurts when pool is too small to absorb it."""
    rng = np.random.default_rng(seed)
    precisions = []
    for _ in range(num_tests):
        scores = rng.uniform(size=n)
        noisy = scores + (rng.normal(0.0, noise_sigma, n)
                          if noise_sigma > 0 else 0.0)
        true_top = set(np.argpartition(-scores, k - 1)[:k].tolist())
        survivors = []
        for part in np.array_split(np.arange(n), b):
            s = noisy[part]
            m = min(partition_k, len(part))
            survivors.append(part[np.argpartition(-s, m - 1)[:m]])
        surv = np.concatenate(survivors)
        p = min(pool, len(surv))
        cand = (surv if p == len(surv)
                else surv[np.argpartition(-noisy[surv], p - 1)[:p]])
        final = (cand if len(cand) <= k
                 else cand[np.argpartition(-scores[cand], k - 1)[:k]])
        precisions.append(len(true_top & set(final.tolist())) / k)
    return float(np.mean(precisions))


def monte_carlo_precision(
    n: int, b: int, k: int, partition_k: int, num_tests: int = 10,
    seed: int | None = 0,
) -> float:
    """Monte-Carlo estimate (topk_errors.py:47-83): random scores, true
    top-k vs the union of per-partition top-partition_k."""
    rng = np.random.default_rng(seed)
    precisions = []
    for _ in range(num_tests):
        scores = rng.uniform(size=n)
        true_top = set(np.argpartition(-scores, k - 1)[:k].tolist())
        survivors = []
        for part in np.array_split(np.arange(n), b):
            s = scores[part]
            keep = part[np.argpartition(-s, min(partition_k, len(part)) - 1)[:partition_k]]
            survivors.append(keep)
        surv = np.concatenate(survivors)
        # fewer survivors than k (b * partition_k < k): they are all kept
        approx_top = (surv if len(surv) <= k
                      else surv[np.argpartition(-scores[surv], k - 1)[:k]])
        precisions.append(len(true_top & set(approx_top.tolist())) / k)
    return float(np.mean(precisions))
