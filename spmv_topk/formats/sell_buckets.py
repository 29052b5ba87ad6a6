"""Bucketed uniform-width SELL-128: the device layout of the sparse sweep.

Rows are degree-sorted (sigma-sort) and cut into slices of 128 rows, one
row per lane. A slice of padded width W is a (W, 128) block of 32-bit
words: word j of every row sits in slice row j, so the 128 words of one
slice row are contiguous and one row of a slice is read by 128
consecutive threads.

  - slices with equal padded width W form contiguous runs; W is quantized
    to a ladder and each run becomes a *bucket* of shape
    (num_slices, W, 128);
  - within a bucket every slice has the same static W, so the sweep over a
    bucket is one fixed-shape decode + gather + reduction over W, with no
    per-row metadata and no dynamic control flow.

This plays the role of the reference's single fixed BSCSR packet geometry
(types.hpp:61-73): where the FPGA fixes B at synthesis time for all data,
the sweep fixes W per degree bucket at trace time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import LANES, TopKSpMVConfig, DEFAULT_CONFIG
from .coo import CooMatrix
from ..ops.fixedpoint import quantize as quantize_values, bf16_bits

# Quantized slice widths: multiples of 8 with ~1.25 geometric spacing
# above 64 (bounded padding from quantization).
W_LADDER = [8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
            224, 256, 320, 384, 448, 512, 640, 768, 896, 1024, 1280, 1536,
            1792, 2048, 2560, 3072, 4096, 8192, 16384, 32768]

# Finer ladders: quantum 4 adds every multiple of 4 below 128, quantum 2
# every even width below 32 and multiples of 4 to 64, quantum 1 every
# width below 32, even widths to 64 and multiples of 4 to 128. Finer
# ladders cut width-quantization padding (the gap between a row's degree
# and its slice's width) at the cost of more buckets.
W_LADDER_Q4 = sorted(set(list(range(4, 129, 4)) + W_LADDER))
W_LADDER_Q2 = sorted(set(
    list(range(2, 33, 2)) + list(range(32, 65, 4)) + W_LADDER_Q4))
W_LADDER_Q1 = sorted(set(
    list(range(1, 33)) + list(range(32, 65, 2)) + list(range(64, 129, 4))
    + W_LADDER_Q2))


def _quantize_w(w: int, quantum: int = 8) -> int:
    ladder = (W_LADDER_Q1 if quantum == 1
              else W_LADDER_Q2 if quantum == 2
              else W_LADDER_Q4 if quantum == 4 else W_LADDER)
    for q in ladder:
        if w <= q:
            return q
    return -(-w // 8) * 8


@dataclasses.dataclass
class SellBucket:
    """One uniform-W run of slices."""

    words: np.ndarray        # (num_slices, W, 128) int32
    width: int               # W: words per row (static)
    slice_base: int          # global index of the bucket's first slice

    @property
    def num_slices(self) -> int:
        return self.words.shape[0]


@dataclasses.dataclass
class BucketedSellMatrix:
    buckets: list
    row_ids: np.ndarray      # (num_slices, 128) int32; -1 = padding lane
    num_rows: int
    num_cols: int
    num_nnz: int
    config: TopKSpMVConfig
    value_scale: float = 1.0  # h16: global 6-bit value quantization scale
    #   (swept scores are sums of 6-bit integers times the query; multiply
    #   by value_scale to recover dot-product units)

    @property
    def num_slices(self) -> int:
        return self.row_ids.shape[0]

    @property
    def hbm_bytes(self) -> int:
        return sum(int(b.words.nbytes) for b in self.buckets)

    @property
    def padded_nnz(self) -> int:
        return sum(b.words.size for b in self.buckets)

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / max(self.num_nnz, 1)


def pack_sell_buckets(
    coo: CooMatrix, config: TopKSpMVConfig = DEFAULT_CONFIG,
    value_scale: float | None = None,
) -> BucketedSellMatrix:
    """value_scale: h16 only — the global 6-bit value quantization scale.
    None computes it from this matrix; sharded engines pass the global
    max so per-shard scores stay comparable across devices."""
    if coo.num_cols > config.max_cols:
        raise ValueError(
            f"matrix has {coo.num_cols} cols > config.max_cols={config.max_cols}"
        )
    if not coo.is_sorted_row_major():
        coo = coo.sort_row_major()
    from ..utils import native

    h16 = config.query_codec == "h16"

    degrees = coo.row_degrees()
    num_slices = -(-coo.num_rows // LANES)
    pad_rows = num_slices * LANES - coo.num_rows
    vals_q = None if h16 else quantize_values(coo.vals, config.value_format)

    row_start = np.zeros(coo.num_rows + 1, dtype=np.int64)
    np.cumsum(degrees, out=row_start[1:])

    if h16:
        # h16 pairs two consecutive nnz of a row per 32-bit word: slice
        # widths, plan, and scatter all operate on WORD degrees
        # ceil(d/2); values are 6-bit signed with one global scale.
        if value_scale is None:
            vmax = float(np.max(np.abs(coo.vals))) if coo.nnz else 1.0
            value_scale = (vmax / 31.0) or 1.0
        plan_degrees = (-(-degrees // 2)).astype(np.int32)
    else:
        value_scale = 1.0
        plan_degrees = degrees

    Q = config.width_quantum
    plan = native.sell_plan(plan_degrees, Q, config.sigma_sort)
    if plan is not None:
        perm, rank_of_row, slice_w = plan
    else:
        perm = (np.argsort(-plan_degrees, kind="stable") if config.sigma_sort
                else np.arange(coo.num_rows))
        rank_of_row = np.empty(coo.num_rows, dtype=np.int64)
        rank_of_row[perm] = np.arange(coo.num_rows)
        deg_padded = np.concatenate(
            [plan_degrees[perm], np.zeros(pad_rows, np.int32)])
        slice_w = deg_padded.reshape(num_slices, LANES).max(axis=1)
        slice_w = np.maximum(-(-slice_w // Q) * Q, Q)

    # Quantize widths to the ladder; sigma-sorted slices make equal-W runs
    # contiguous (width is monotone when sigma_sort, nearly so otherwise).
    slice_wq = np.array([_quantize_w(int(w), Q) for w in slice_w], np.int64)

    # Merge runs into the previous (wider) one while a global padding
    # budget lasts: every distinct width is a separately compiled sweep,
    # but promotion widens slices, so the TOTAL widening across all
    # promotions is capped at ~1% of the packed words — per-run caps
    # compound into large padding on width-diverse (quantum-4) packs.
    if config.sigma_sort and num_slices > 1:
        budget = max(16, int(slice_wq.sum()) // 100)
        i = 0
        cur_w = None
        while i < num_slices:
            j = i
            w = int(slice_wq[i])
            while j < num_slices and slice_wq[j] == w:
                j += 1
            cost = (j - i) * (cur_w - w) if cur_w is not None else None
            if cost is not None and cost <= budget:
                slice_wq[i:j] = cur_w
                budget -= cost
            else:
                cur_w = w
            i = j

    perm_padded = np.concatenate([perm, np.full(pad_rows, -1, np.int64)])
    row_ids = perm_padded.reshape(num_slices, LANES).astype(np.int32)

    slice_off = np.zeros(num_slices + 1, dtype=np.int64)
    np.cumsum(slice_wq, out=slice_off[1:])
    total_sub = int(slice_off[-1])

    # Scatter all nnz once into the quantized-width global slab.
    if h16:
        words = _scatter_h16(coo, degrees, row_start, rank_of_row,
                             slice_off, total_sub, value_scale)
    else:
        words = native.sell_scatter(
            coo.rows, coo.cols, vals_q, row_start, rank_of_row, slice_off,
            total_sub,
        )
    if words is None:
        slice_of_row = rank_of_row // LANES
        lane_of_row = rank_of_row % LANES
        within_row = np.arange(coo.nnz, dtype=np.int64) - row_start[coo.rows]
        dest_sub = slice_off[slice_of_row[coo.rows]] + within_row
        dest_lane = lane_of_row[coo.rows]
        w32 = np.zeros((total_sub, LANES), dtype=np.uint32)
        w32[dest_sub, dest_lane] = (
            (coo.cols.astype(np.uint32) << 16)
            | bf16_bits(vals_q).astype(np.uint32)
        )
        words = w32.view(np.int32)

    # Cut into buckets = contiguous equal-W runs.
    buckets = []
    t = 0
    while t < num_slices:
        W = int(slice_wq[t])
        t_end = t
        while t_end < num_slices and slice_wq[t_end] == W:
            t_end += 1
        sub0 = int(slice_off[t])
        sub1 = int(slice_off[t_end])
        buckets.append(SellBucket(
            words=words[sub0:sub1].reshape(t_end - t, W, LANES),
            width=W, slice_base=t))
        t = t_end

    return BucketedSellMatrix(
        buckets=buckets, row_ids=row_ids,
        num_rows=coo.num_rows, num_cols=coo.num_cols, num_nnz=coo.nnz,
        config=config, value_scale=value_scale,
    )


def _scatter_h16(coo: CooMatrix, degrees, row_start, rank_of_row,
                 slice_off, total_sub, value_scale: float) -> np.ndarray:
    """Pair-pack the COO for the h16 codec.

    Word layout (2 nnz per int32):
      bits [ 0:10)  col of nnz 2p      [10:16)  val6 of nnz 2p
      bits [16:26)  col of nnz 2p+1    [26:32)  val6 of nnz 2p+1
    val6 = two's-complement round(val / value_scale) in [-31, 31]; an odd
    row degree leaves the high half 0 (val6=0 contributes nothing, any
    col is safe). Slice geometry uses word degrees ceil(d/2).

    Dispatches to the native threaded scatter (runtime/spmv_runtime.cpp::
    h16_scatter) when built; this NumPy body is the fallback and the
    differential oracle (tests/test_native.py) — its temporaries are ~9x
    the packed size, prohibitive at the 2G-nnz BASELINE config.
    """
    from ..utils import native

    nw = native.h16_scatter(
        np.ascontiguousarray(coo.rows, np.int32),
        np.ascontiguousarray(coo.cols, np.int32),
        np.ascontiguousarray(coo.vals, np.float32),
        np.ascontiguousarray(row_start, np.int64),
        np.ascontiguousarray(rank_of_row, np.int64),
        np.ascontiguousarray(slice_off, np.int64),
        total_sub, value_scale)
    if nw is not None:
        return nw
    # memory hygiene: a 100M-row corpus (~2G nnz) peaks near host RAM —
    # keep temporaries int32 where ranges allow and free them eagerly
    v6 = np.clip(np.rint(coo.vals * np.float32(1.0 / value_scale)),
                 -31, 31).astype(np.int32)
    halves = (coo.cols.astype(np.uint32)
              | ((v6 & 0x3F).astype(np.uint32) << np.uint32(10)))
    del v6

    pair_degrees = -(-degrees.astype(np.int64) // 2)
    pair_start = np.zeros(coo.num_rows + 1, np.int64)
    np.cumsum(pair_degrees, out=pair_start[1:])
    total_pairs = int(pair_start[-1])

    within = np.arange(coo.nnz, dtype=np.int64)
    within -= row_start[coo.rows]
    pid = pair_start[coo.rows] + (within >> 1)
    hi = (within & 1).astype(bool)
    del within
    pw = np.zeros(total_pairs, np.uint32)
    pw[pid[~hi]] = halves[~hi]            # exactly one low half per pair
    pw[pid[hi]] |= halves[hi] << np.uint32(16)
    del pid, hi, halves

    pair_rows = np.repeat(
        np.arange(coo.num_rows, dtype=np.int32), pair_degrees)
    rk = rank_of_row[pair_rows]
    dest_sub = np.arange(total_pairs, dtype=np.int64)
    dest_sub -= pair_start[pair_rows]
    del pair_rows
    dest_sub += slice_off[rk // LANES]
    w32 = np.zeros((total_sub, LANES), np.uint32)
    w32[dest_sub, rk % LANES] = pw
    return w32.view(np.int32)
