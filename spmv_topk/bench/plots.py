"""Figure generation from sweep CSVs.

Counterpart of the reference's plotting suite
(/root/reference/src/resources/python/plotting/: plot_exec_time.py,
plot_errors.py, plot_roofline.py — 2.7k LoC of paper figures). Reads the
CSVs written by bench.sweep (same naming convention,
{impl}_{rows}_{cols}_{dist}_{deg}_{bits}_{parts}_{k}_{iters}.csv,
cf. plot_errors.py:52) and produces:

  - exec-time / throughput bars across configurations (plot_exec_time.py)
  - accuracy curves: precision / NDCG / Kendall-tau per config
    (plot_errors.py:85-94)
  - a roofline chart: achieved nnz/s vs the device's memory roofline at
    the format's operational intensity (plot_roofline.py:178-209)

Usage: python -m spmv_topk.bench.plots results/ --out results/plots
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

# Published device-memory bandwidth by JAX device_kind, GB/s (NVIDIA's
# data sheets: H100 SXM 3.35 TB/s, H200 SXM 4.8 TB/s), for roofline
# accounting (plot_roofline.py hard-codes the U280/P100/Xeon equivalents
# at :180-209). A device missing here has no roofline: hbm_peak_gbps
# raises rather than guess.
DEVICE_PEAKS_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H200": 4800.0,
}


def hbm_peak_gbps(device_kind: str) -> float:
    try:
        return DEVICE_PEAKS_GBPS[device_kind]
    except KeyError:
        raise KeyError(f"no published memory bandwidth for device kind "
                       f"{device_kind!r}; add it to DEVICE_PEAKS_GBPS") from None

REFERENCE_POINTS = [
    # label, GNNZ/s (BASELINE.md)
    ("CPU 2x Xeon 6248 (sparse_dot_topn)", 0.4),
    ("GPU P100 F32 (cuSPARSE)", 27.0),
    ("GPU P100 F16", 30.0),
    ("FPGA U280 32c 32-bit", 50.0),
    ("FPGA U280 32c 20-bit", 76.9),
]


def _parse_name(path: str) -> dict:
    parts = os.path.basename(path)[:-4].split("_")
    return dict(impl=parts[0], rows=int(parts[1]), cols=int(parts[2]),
                dist=parts[3], deg=int(parts[4]), bits=parts[5],
                partitions=int(parts[6]), k=int(parts[7]),
                iters=int(parts[8]))


def load_results(results_dir: str):
    """All sweep CSVs of `results_dir` as one pandas DataFrame."""
    import pandas as pd

    frames = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.csv"))):
        meta = _parse_name(path)
        df = pd.read_csv(path)
        for key, val in meta.items():
            df[key] = val
        df["config"] = os.path.basename(path)[:-4]
        frames.append(df)
    if not frames:
        raise FileNotFoundError(f"no CSVs in {results_dir}")
    return pd.concat(frames, ignore_index=True)


def plot_exec_time(df, out: str, warmup_skip: int = 2):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = (df[df.iteration >= warmup_skip]
         .groupby("config")["hw_exec_time_ms"].agg(["mean", "std"]))
    fig, ax = plt.subplots(figsize=(max(6, 0.6 * len(g)), 4))
    ax.bar(range(len(g)), g["mean"], yerr=g["std"], capsize=3)
    ax.set_xticks(range(len(g)))
    ax.set_xticklabels(g.index, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("exec time [ms]")
    fig.tight_layout()
    fig.savefig(os.path.join(out, "exec_time.png"), dpi=150)
    plt.close(fig)


def plot_errors(df, out: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = ["precision", "ndcg", "kendall_tau"]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5), sharey=True)
    for ax, mname in zip(axes, metrics):
        g = df.groupby("config")[mname].mean()
        ax.bar(range(len(g)), g.values)
        ax.set_xticks(range(len(g)))
        ax.set_xticklabels(g.index, rotation=45, ha="right", fontsize=6)
        ax.set_title(mname)
        ax.set_ylim(0.0, 1.02)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "errors.png"), dpi=150)
    plt.close(fig)


def plot_roofline(df, out: str, bytes_per_nnz: float = 4.25,
                  chip: str = "NVIDIA H100 80GB HBM3", warmup_skip: int = 2):
    """Achieved nnz/s per config vs the device memory roofline and the
    published reference points (plot_roofline.py:178-209)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    peak = hbm_peak_gbps(chip)
    roof_gnnz = peak / bytes_per_nnz

    nnz_per_cfg = df.groupby("config").apply(
        lambda x: x["rows"].iloc[0] * x["deg"].iloc[0], include_groups=False)
    t = (df[df.iteration >= warmup_skip]
         .groupby("config")["hw_exec_time_ms"].mean())
    gnnz = (nnz_per_cfg / (t / 1e3)) / 1e9

    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.bar(range(len(gnnz)), gnnz.values, label=f"{chip} (this work)")
    ax.axhline(roof_gnnz, ls="--", c="k",
               label=f"memory roofline {roof_gnnz:.0f} GNNZ/s @ {bytes_per_nnz} B/nnz")
    for label, val in REFERENCE_POINTS:
        ax.axhline(val, ls=":", lw=0.8, c="gray")
        ax.annotate(label, (len(gnnz) - 0.5, val), fontsize=6, va="bottom",
                    ha="right")
    ax.set_xticks(range(len(gnnz)))
    ax.set_xticklabels(gnnz.index, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("GNNZ/s")
    ax.set_yscale("log")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "roofline.png"), dpi=150)
    plt.close(fig)


def plot_sparsity(coo, out: str, name: str = "matrix"):
    """Degree distribution + packing overhead figure (the analog of the
    reference's plot_sparsity.py, which histograms nnz/row per dataset).

    Left: row-degree histogram. Right: packed words per nnz (the
    streamed-bytes inflation from width quantization) for the
    layout variants — this is the figure that guides W_LADDER /
    width_quantum tuning: the gap between a bar and 1.0 is bandwidth
    spent streaming padding.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..config import TopKSpMVConfig
    from ..formats.sell_buckets import pack_sell_buckets

    deg = coo.row_degrees()
    variants = [
        ("sigma q8", dict(sigma_sort=True, width_quantum=8)),
        ("sigma q4", dict(sigma_sort=True, width_quantum=4)),
        ("no-sigma q8", dict(sigma_sort=False, width_quantum=8)),
        ("sigma q4 h16", dict(sigma_sort=True, width_quantum=4,
                              query_codec="h16")),
    ]
    ratios = []
    for label, kw in variants:
        cfg = TopKSpMVConfig(max_cols=-(-coo.num_cols // 128) * 128, **kw)
        m = pack_sell_buckets(coo, cfg)
        # h16 packs 2 nnz/word: report stream words per PACKED word so
        # the bars measure layout padding, not codec compression
        denom = (coo.nnz + 1) // 2 if kw.get("query_codec") == "h16" \
            else coo.nnz
        ratios.append((label, m.padded_nnz / max(denom, 1)))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.8))
    ax1.hist(deg, bins=min(100, max(int(deg.max()), 2)), log=True)
    ax1.set_xlabel("nnz per row")
    ax1.set_ylabel("rows")
    ax1.set_title(f"{name}: degree distribution "
                  f"(mean {deg.mean():.1f}, max {deg.max()})", fontsize=9)
    labels = [r[0] for r in ratios]
    ax2.bar(range(len(ratios)), [r[1] for r in ratios])
    ax2.axhline(1.0, ls="--", c="k", lw=0.8)
    for i, (_, v) in enumerate(ratios):
        ax2.annotate(f"{v:.3f}", (i, v), ha="center", va="bottom",
                     fontsize=8)
    ax2.set_xticks(range(len(ratios)))
    ax2.set_xticklabels(labels, rotation=20, ha="right", fontsize=8)
    ax2.set_ylabel("stream words / nnz word")
    ax2.set_title("packing overhead by layout", fontsize=9)
    fig.tight_layout()
    path = os.path.join(out, "sparsity.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return ratios


def plot_convergence(out: str, n: int = 200_000, k: int = 100,
                     num_tests: int = 5):
    """Accuracy-convergence figure (the analog of the reference's
    plot_convergence.py, which tracked its iterative method's error vs
    iterations; this method is one-shot, so its convergence axes are the
    approximation knobs approaching exactness — the same knobs
    topk_errors.py sweeps).

    Left: closed-form precision@K vs per-partition k (lane_k) for the
    partition counts of the sweep (128 lanes per device x devices) plus
    the FPGA's 32, with Monte-Carlo dots as a check.
    Right: Monte-Carlo precision@K of the full serving pipeline vs
    rescore-pool size under codec score noise — where the shipped
    pool=400 default sits on the curve.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..eval.accuracy_model import (closed_form_precision,
                                       monte_carlo_precision,
                                       monte_carlo_rescore_precision)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.8))

    lane_ks = [1, 2, 3, 4, 6, 8, 12, 16]
    for b, label in [(32, "32 parts (FPGA)"), (128, "128 (1 device)"),
                     (512, "512 (4 devices)"), (1024, "1024 (8 devices)")]:
        cf = [closed_form_precision(n, b, k, pk) for pk in lane_ks]
        line, = ax1.plot(lane_ks, cf, marker=".", label=label)
        mc = [monte_carlo_precision(n, b, k, pk, num_tests=num_tests,
                                    seed=1) for pk in (2, 4, 8)]
        ax1.scatter([2, 4, 8], mc, s=14, c=line.get_color(), zorder=3)
    ax1.set_xlabel("per-partition k (lane_k)")
    ax1.set_ylabel(f"precision@{k}")
    ax1.set_ylim(0.0, 1.02)
    ax1.legend(fontsize=7)
    ax1.set_title("partition-survival convergence "
                  "(lines: closed form, dots: MC)", fontsize=9)

    pools = [k, 2 * k, 4 * k, 8 * k]
    for sigma, label in [(0.0, "exact scores"),
                         (0.01, "codec noise σ=0.01"),
                         (0.03, "codec noise σ=0.03")]:
        pr = [monte_carlo_rescore_precision(
            n, 128, k, 8, pool, noise_sigma=sigma,
            num_tests=num_tests, seed=2) for pool in pools]
        ax2.plot(pools, pr, marker=".", label=label)
    ax2.axvline(4 * k, ls="--", c="k", lw=0.8)
    ax2.annotate("shipped pool=400", (4 * k, ax2.get_ylim()[0]),
                 fontsize=7, ha="left", va="bottom", rotation=90)
    ax2.set_xlabel("rescore pool size")
    ax2.set_ylabel(f"precision@{k} after exact rescore")
    ax2.legend(fontsize=7)
    ax2.set_title("rescore-pool convergence (128 parts, lane_k=8)",
                  fontsize=9)

    fig.tight_layout()
    path = os.path.join(out, "convergence.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("results_dir", nargs="?")
    ap.add_argument("--out", default=None)
    ap.add_argument("--chip", default="NVIDIA H100 80GB HBM3",
                    help="JAX device_kind of the measured device")
    ap.add_argument("--sparsity", default=None, metavar="ROWSxCOLSxDEGxDIST",
                    help="also emit the degree/padding figure for a "
                    "synthetic matrix, e.g. 1000000x1024x20xgamma")
    ap.add_argument("--convergence", action="store_true",
                    help="also emit the accuracy-convergence figure "
                    "(lane_k / rescore-pool sweeps of the analytic model)")
    args = ap.parse_args()
    out = args.out or os.path.join(args.results_dir or ".", "plots")
    os.makedirs(out, exist_ok=True)
    if args.convergence:
        print(f"  convergence -> {plot_convergence(out)}")
    if args.sparsity:
        from ..formats.synthetic import create_sparse_matrix

        r, c, d, dist = args.sparsity.split("x")
        coo = create_sparse_matrix(int(r), int(c), int(d), dist, seed=1)
        ratios = plot_sparsity(coo, out, name=args.sparsity)
        for label, v in ratios:
            print(f"  {label:16s} {v:.3f} words/nnz-word")
    if args.results_dir:
        df = load_results(args.results_dir)
        plot_exec_time(df, out)
        plot_errors(df, out)
        plot_roofline(df, out, chip=args.chip)
    print(f"wrote plots to {out}")


if __name__ == "__main__":
    main()
