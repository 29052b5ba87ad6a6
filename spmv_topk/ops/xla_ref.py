"""Plain references for the sparse sweep (no custom kernels).

Two roles:
  1. `sell_scores_np` / `topk_spmv_sell_xla`: a NumPy re-statement of the
     sweep's exact semantics over the same packed buckets — the analog of
     the reference's packet-accurate software model
     (spmv_coo_gold_top_k_packet, gold_algorithms.hpp:277-362), used as
     the differential oracle in tests and on the card.
  2. `topk_spmv_segment_xla`: the two-phase baseline (full SpMV then top-k),
     the analog of the reference's GPU hosts (cusparseSpMV + thrust full
     argsort + gather, host_spmv_topk_csr_gpu.cu:171-231).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.sell_buckets import BucketedSellMatrix


def _decode_np(words: np.ndarray, codec: str):
    """[(cols, values)] pairs of one bucket's packed words (see
    formats/sell_buckets.py for both word layouts)."""
    w = words.view(np.uint32)
    if codec == "f32":
        return [((w >> 16).astype(np.int64), (w << 16).view(np.float32))]
    out = []
    for shift in (0, 16):
        h = (w >> shift) & 0xFFFF
        v6 = ((h >> 10) & 0x3F).astype(np.int32)
        out.append(((h & 0x3FF).astype(np.int64),
                    np.where(v6 >= 32, v6 - 64, v6).astype(np.float32)))
    return out


def sell_scores_np(m: BucketedSellMatrix, query: np.ndarray) -> np.ndarray:
    """Per-row scores of the packed matrix, in original row order.

    f32 products of the decoded values (bf16 for the f32 codec, 6-bit
    integers times value_scale for h16) and the f32 query, summed in f32
    over each row's words. The device sweep sums the same products in
    another order, so the two agree to f32 rounding."""
    query = np.asarray(query, np.float32)
    codec = m.config.query_codec
    scores = np.zeros(m.num_rows, np.float32)
    for b in m.buckets:
        acc = np.zeros((b.num_slices, b.words.shape[2]), np.float32)
        for cols, vals in _decode_np(b.words, codec):
            acc += (vals * query[np.minimum(cols, len(query) - 1)]).sum(
                axis=1, dtype=np.float32)
        ids = m.row_ids[b.slice_base:b.slice_base + b.num_slices]
        real = ids >= 0
        scores[ids[real]] = acc[real]
    return scores * np.float32(m.value_scale)


@functools.partial(jax.jit, static_argnames=("num_rows", "k"))
def topk_spmv_segment_xla(rows, cols, vals, query, num_rows: int, k: int):
    """Two-phase Top-K SpMV: segment-sum SpMV then lax.top_k.

    The reference GPU path computes the full dense result then a full
    argsort (host_spmv_topk_csr_gpu.cu:199-218); XLA's top_k avoids the
    full sort but the result vector is still materialized.
    """
    prods = vals * query[cols]
    scores = jax.ops.segment_sum(prods, rows, num_segments=num_rows)
    v, i = jax.lax.top_k(scores, k)
    return i.astype(jnp.int32), v


def topk_spmv_sell_xla(m: BucketedSellMatrix, query: np.ndarray, k: int):
    """Exact Top-K over the packed matrix's scores (NumPy)."""
    scores = sell_scores_np(m, query)
    k = min(k, m.num_rows)
    part = np.argpartition(-scores, k - 1)[:k]
    order = np.argsort(-scores[part], kind="stable")
    idx = part[order]
    return idx.astype(np.int32), scores[idx].astype(np.float32)
