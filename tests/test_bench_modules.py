"""Smoke tests for the benchmark/figure modules (bench/sweep, bench/plots,
bench/cpu_baseline): the counterparts of the reference's sweep driver
(test_spmv_topk.py) and plotting suite (src/resources/python/plotting/)."""

import glob
import os

import numpy as np
import pytest

from spmv_topk.formats import create_sparse_matrix


def test_sweep_then_plots(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from spmv_topk.bench.sweep import run_sweep
    from spmv_topk.bench import plots

    out = str(tmp_path / "results")
    summary = run_sweep([1500], [256], ["uniform"], [8], k=20,
                        num_tests=3, out_dir=out)
    assert len(summary) == 1
    assert summary[0]["precision"] >= 0.95
    csvs = glob.glob(os.path.join(out, "*.csv"))
    assert len(csvs) == 1
    # reference CSV naming convention (plot_errors.py:52)
    assert os.path.basename(csvs[0]).startswith("jax-f32_1500_256_uniform_8")

    df = plots.load_results(out)
    assert len(df) == 3                 # one row per iteration
    assert df["config"].nunique() == 1
    pdir = str(tmp_path / "plots")
    os.makedirs(pdir, exist_ok=True)
    plots.plot_exec_time(df, pdir)
    plots.plot_errors(df, pdir)
    plots.plot_roofline(df, pdir)
    made = glob.glob(os.path.join(pdir, "*.png"))
    assert len(made) >= 3


def test_cpu_baseline():
    from spmv_topk.bench.cpu_baseline import topk_cpu

    coo = create_sparse_matrix(2000, 256, 8, "uniform", seed=40)
    rng = np.random.default_rng(41)
    q = rng.standard_normal(256).astype(np.float32)
    q /= np.linalg.norm(q)
    idx, vals = topk_cpu(coo.to_scipy(), q, 25)
    dense = coo.to_scipy() @ q
    gold = np.argsort(-dense)[:25]
    assert set(idx.tolist()) == set(gold.tolist())


def test_plot_sparsity(tmp_path):
    """Degree/padding figure (plot_sparsity.py analog, VERDICT r1 #10)."""
    import os

    from spmv_topk.bench import plots
    from spmv_topk.formats import create_sparse_matrix

    coo = create_sparse_matrix(100_000, 512, 15, "gamma", seed=90)
    out = str(tmp_path)
    ratios = plots.plot_sparsity(coo, out, name="t")
    assert os.path.exists(os.path.join(out, "sparsity.png"))
    assert len(ratios) == 4
    by = dict(ratios)
    # sigma-sorted layouts must be near-dense; unsorted explodes on gamma
    assert by["sigma q8"] < 2.0
    assert by["no-sigma q8"] > by["sigma q8"]


def test_plot_convergence(tmp_path):
    """Accuracy-convergence figure (plot_convergence.py analog)."""
    import os

    from spmv_topk.bench import plots

    path = plots.plot_convergence(str(tmp_path), n=20_000, num_tests=2)
    assert os.path.exists(path)


def test_accuracy_sweep_tiny(tmp_path):
    """Measured accuracy-vs-K sweep (VERDICT r3 #5): the module runs the
    real engine per K and beats the reference's bars on a tiny corpus."""
    from spmv_topk.bench import accuracy_sweep

    res = accuracy_sweep.run(rows=4000, cols=256, deg=10, trials=2,
                             ks=(8, 16, 32), rescore_pool=64)
    assert len(res["configs"]) == 4  # 2 dists x {production, raw}
    for c in res["configs"]:
        for K in (8, 16, 32):
            m = c["metrics"][K]
            assert 0.0 <= m["precision"] <= 1.0
            if c["mode"] == "production":
                assert m["precision"] >= 0.95, (c["dist"], K, m)
    out = str(tmp_path / "acc.json")
    import json

    with open(out, "w") as fh:
        json.dump(res, fh)
    accuracy_sweep.plot(res, str(tmp_path / "acc.png"))
    assert (tmp_path / "acc.png").exists()
