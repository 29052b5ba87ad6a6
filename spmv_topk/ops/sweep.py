"""The sparse Top-K sweep over the bucketed SELL-128 layout, in plain JAX.

A re-design of the reference's HLS dataflow kernel
(/root/reference/src/fpga/src/ip/spmv/spmv_bscsr_top_k_multicore.hpp:
loop_1 decode+gather :168-220, loop_2 multiply+segment-reduce :104-149,
loop_3 packet stitching :246-326, loop_4 argmin-replacement Top-K
:331-409). The mapping:

  loop_1  -> decode each packed word (formats/sell_buckets.py) into its
             column and value, and gather the query at the column;
  loop_2  -> multiply and sum over the W words of each row: in SELL-128
             every lane of a (W, 128) slice is one row, so the segmented
             reduction is a plain sum over W;
  loop_3  -> not needed: rows never straddle slices;
  loop_4  -> per-lane Top-`lane_k` over the slice axis with `lax.top_k`
             (first of tied scores wins, as in the reference's argmin
             replacement); candidates are (value, slice) pairs resolved to
             row ids by `finalize_topk`.

The scores of every row are materialised once (4 B per row written and
read back) between the reduction and the per-lane Top-K.

`query_batch` runs the same sweep with the queries innermost: the query
operand is the (C, Q) transpose of the group, each nonzero gathers one
row of it, and each packed word is read once per group.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Scores of real rows are finite and far above this; masked (padding)
# slots hold -inf and are dropped by `finalize_topk`.
TOPK_FLOOR = -1e38


def _gather(x, cols):
    """x[cols] along axis 0. Clamping keeps an out-of-range column finite
    (jnp.take's default fill mode would return NaN); padding words decode
    to column 0 with value 0, so they add exactly 0."""
    return jnp.take(x, cols, axis=0, mode="clip")


def _times(vals, gathered):
    # (S, W, 128) values against (S, W, 128) or (S, W, 128, Q) query rows
    return (vals if gathered.ndim == vals.ndim else vals[..., None]) * gathered


def bucket_scores(words, x, codec: str):
    """Row scores of one bucket: (S, W, 128) words -> (S, 128) for a (C,)
    query, or (S, 128, Q) for a (C, Q) query group."""
    if codec == "f32":
        # (col << 16) | bf16 value bits
        cols = jax.lax.shift_right_logical(words, 16)
        vals = jax.lax.bitcast_convert_type(
            jax.lax.shift_left(words, 16), jnp.float32)
        terms = _times(vals, _gather(x, cols))
    elif codec == "h16":
        # two halves of col[0:10) | signed val6[10:16)
        c0 = words & 0x3FF
        c1 = jax.lax.shift_right_logical(words, 16) & 0x3FF
        v0 = jax.lax.shift_right_arithmetic(
            jax.lax.shift_left(words, 16), 26).astype(jnp.float32)
        v1 = jax.lax.shift_right_arithmetic(words, 26).astype(jnp.float32)
        terms = _times(v0, _gather(x, c0)) + _times(v1, _gather(x, c1))
    else:
        raise ValueError(f"unknown query codec {codec!r}")
    return terms.sum(axis=1)


def sweep_scores(buckets, x, codec: str):
    """Scores of every slice row, in slice order: (S, 128) or (S, 128, Q).
    Buckets hold contiguous slice ranges, so concatenation is slice order."""
    parts = [bucket_scores(w, x, codec) for w in buckets]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)


def lane_topk(scores, valid, lane_k: int):
    """Per-lane Top-`lane_k` over the slice axis.

    scores: (S, 128) or (S, 128, Q); valid: (S, 128) bool, False on
    padding lanes and padding slices, which score -inf so they cannot take
    a real row's slot. Returns (values, slice ids) of shape (K, 128) or
    (Q, K, 128), K = min(lane_k, S)."""
    mask = valid if scores.ndim == 2 else valid[..., None]
    s = jnp.where(mask, scores, -jnp.inf)
    s = jnp.moveaxis(s, 0, -1)                  # (128, S) or (128, Q, S)
    if s.ndim == 3:
        s = jnp.swapaxes(s, 0, 1)               # (Q, 128, S)
    v, t = jax.lax.top_k(s, min(lane_k, s.shape[-1]))
    return jnp.swapaxes(v, -1, -2), jnp.swapaxes(t, -1, -2)


def finalize_topk(topv, topt, row_ids, k: int):
    """Global Top-K merge of the per-lane candidates.

    Replaces the reference's host-side read_result (offset + hash-dedupe +
    sort, host_spmv_bscsr.cpp:399-448): candidates are already unique
    (one per (slice, lane)), so the merge is a single lax.top_k over all
    (lane_k, 128) candidates, with padding slots masked out. At most
    lane_k * 128 rows can be returned."""
    L = row_ids.shape[1]
    flat_v = topv.reshape(-1)
    lane = jax.lax.broadcasted_iota(
        jnp.int32, topv.shape, topv.ndim - 1).reshape(-1)
    rows = row_ids.reshape(-1)[topt.reshape(-1) * L + lane]
    valid = (rows >= 0) & (flat_v > TOPK_FLOOR)
    masked = jnp.where(valid, flat_v, -jnp.inf)
    vals, pos = jax.lax.top_k(masked, min(k, masked.shape[0]))
    return rows[pos], vals


@functools.partial(jax.jit, static_argnames=("codec", "lane_k", "k"))
def topk_query(buckets, valid, row_ids, x, *, codec: str, lane_k: int,
               k: int):
    """(indices, values) of the Top-`k` rows for a (C,) query, or of shape
    (Q, k) for a (C, Q) query group. Values are in swept units (h16:
    multiply by the matrix's value_scale)."""
    topv, topt = lane_topk(sweep_scores(buckets, x, codec), valid, lane_k)
    if x.ndim == 1:
        return finalize_topk(topv, topt, row_ids, k)
    return jax.vmap(lambda v, t: finalize_topk(v, t, row_ids, k))(topv, topt)


@functools.partial(jax.jit, static_argnames=("codec",))
def scores_device(buckets, x, *, codec: str):
    """Device scores of every slice row, (S, 128), for one (C,) query."""
    return sweep_scores(buckets, x, codec)
