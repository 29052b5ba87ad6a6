"""Dense batch engine: bf16/int8 matmul sweep + approx_max_k.

An alternative to the sparse sweep for corpora whose DENSE form fits in
device memory (N * C * 2 bytes at bf16; N * C at int8 with per-row
scales, doubling the servable corpus). At ~2% density the dense sweep
does ~50x the FLOPs of the sparse one, but it runs on the matrix units
(bf16 with f32 accumulation, or s8 x s8 -> s32) at a fixed cadence per
row block, so for wide query batches its cost per query can fall below
the sparse sweep's. Not measured yet on the H100.

This is the counterpart of the reference's GPU baseline (cuSPARSE SpMV +
thrust full argsort, host_spmv_topk_csr_gpu.cu:171-231) with the argsort
replaced by approx_max_k per row block and an exact lax.top_k only for
the tiny final merge over the per-block candidates.

Trade-offs vs TopKSpMV (sparse):
  - memory: dense bf16 (2 GB per 1M x 1024) vs ~4 B/nnz (~90 MB);
  - single-query latency: the dense sweep always reads N*C*2 bytes, so
    sparse wins for one query at low density;
  - accuracy: scores are exact bf16 dots; only the per-block candidate
    selection is approximate (recall_target, default 0.98).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TopKSpMVConfig, DEFAULT_CONFIG
from ..formats.coo import CooMatrix


def densify_bf16(coo: CooMatrix, row_block: int = 1 << 17) -> np.ndarray:
    """COO -> dense bf16-bit uint16 array, built block-wise so the host
    never materializes the f32 dense form at once."""
    out = np.zeros((coo.num_rows, coo.num_cols), np.uint16)
    csr = coo.to_scipy().tocsr()
    for lo in range(0, coo.num_rows, row_block):
        hi = min(lo + row_block, coo.num_rows)
        d = csr[lo:hi].toarray().astype(np.float32)
        out[lo:hi] = (d.view(np.uint32) >> 16).astype(np.uint16)
    return out


def densify_int8(coo: CooMatrix, row_block: int = 1 << 17):
    """COO -> (dense int8 array, per-row f32 scales), built block-wise.

    Per-row symmetric quantization: row r is stored as
    round(A[r] / scale[r]) with scale[r] = max|A[r]| / 127, so the int32
    matmul result times scale[r] recovers the dot product. Per-row (not
    global) scales keep the quantization error proportional to each row's
    own magnitude — the same reduced-precision trade the reference makes
    with its fixed-point values (types.hpp:20-27), but row-adaptive.
    Halves HBM vs bf16, doubling the corpus size the dense engine serves.
    """
    out = np.zeros((coo.num_rows, coo.num_cols), np.int8)
    scales = np.ones(coo.num_rows, np.float32)
    csr = coo.to_scipy().tocsr()
    for lo in range(0, coo.num_rows, row_block):
        hi = min(lo + row_block, coo.num_rows)
        d = csr[lo:hi].toarray().astype(np.float32)
        m = np.abs(d).max(axis=1)
        s = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
        out[lo:hi] = np.rint(d / s[:, None]).astype(np.int8)
        scales[lo:hi] = s
    return out, scales


@functools.partial(jax.jit,
                   static_argnames=("k", "block_rows", "recall_target"))
def dense_topk_batch(A, queries, num_real=None, row_scales=None,
                     query_scales=None, *, k: int, block_rows: int,
                     recall_target: float = 0.98):
    """Top-k rows of A @ queries.T for a (Q, C) query batch.

    A: (N, C) bfloat16 — or int8, in which case `row_scales` is the (N,)
    f32 per-row dequantization scale from densify_int8, `queries` is the
    already-quantized (Q, C) int8 batch, and `query_scales` the (Q,) f32
    per-query scales (selection is per query, so query_scales only affect
    the returned values, applied once at the end).
    N a multiple of block_rows (zero row padding).
    num_real: real-row count (scalar, may be traced — the sharded engine
    passes per-device values); pad rows past it score -inf so their
    exact-zero dot products cannot displace real negative-scoring rows.
    Returns (indices, values) of shape (Q, k).
    """
    Q = queries.shape[0]
    num_blocks = A.shape[0] // block_rows
    int8_mode = A.dtype == jnp.int8
    qt = queries.T if int8_mode else queries.astype(A.dtype).T

    def step(c, b):
        blk = jax.lax.dynamic_slice_in_dim(A, b * block_rows, block_rows, 0)
        if int8_mode:
            s = jnp.dot(blk, qt,                       # s8 x s8 -> s32
                        preferred_element_type=jnp.int32)
            sc = jax.lax.dynamic_slice_in_dim(
                row_scales, b * block_rows, block_rows, 0)
            s = s.astype(jnp.float32) * sc[:, None]    # dequantize (B, Q)
        else:
            s = jnp.dot(blk, qt, preferred_element_type=jnp.float32)
        if num_real is not None:
            rows = (b * block_rows
                    + jax.lax.broadcasted_iota(jnp.int32, s.shape, 0))
            s = jnp.where(rows < num_real, s, -jnp.inf)
        v, i = jax.lax.approx_max_k(s.T, k, recall_target=recall_target)
        return c, (v, i + b * block_rows)

    _, (vs, isx) = jax.lax.scan(step, 0, jnp.arange(num_blocks))
    vs = jnp.moveaxis(vs, 0, 1).reshape(Q, -1)       # (Q, NB*k)
    isx = jnp.moveaxis(isx, 0, 1).reshape(Q, -1)
    kk = min(k, vs.shape[1])
    fv, fp = jax.lax.top_k(vs, kk)                   # tiny exact merge
    if query_scales is not None:
        fv = fv * query_scales[:, None]
    return jnp.take_along_axis(isx, fp, axis=1), fv


def quantize_queries_int8(queries: np.ndarray):
    """(Q, C) f32 -> (int8 device batch, (Q,) f32 per-query scales)."""
    m = np.abs(queries).max(axis=1)
    qscales = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
    qi = np.rint(queries / qscales[:, None]).astype(np.int8)
    return jnp.asarray(qi), jnp.asarray(qscales)


class DenseTopKSpMV:
    """Matrix-resident dense Top-K engine (single device).

    Use for high-throughput batched serving when N * C * 2 bytes fits in
    device memory; use TopKSpMV (sparse streaming) for single-query
    latency or corpora too large to densify.
    """

    def __init__(self, matrix, config: TopKSpMVConfig = DEFAULT_CONFIG,
                 device: Optional[jax.Device] = None,
                 block_rows: int = 1 << 17,
                 recall_target: Optional[float] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 dtype: str = "bf16"):
        if dtype not in ("bf16", "int8"):
            raise ValueError(f"dtype must be 'bf16' or 'int8', got {dtype!r}")
        if not isinstance(matrix, CooMatrix):
            from ..formats.coo import from_scipy

            matrix = from_scipy(matrix)
        self.config = config
        self.dtype = dtype
        self.num_rows = matrix.num_rows
        self.num_cols = matrix.num_cols
        self.num_nnz = matrix.nnz
        # cap the block to the (1024-aligned) corpus height so small
        # corpora aren't zero-padded up to a full 131072-row block
        self.block_rows = min(block_rows, 1 << 20,
                              -(-matrix.num_rows // 1024) * 1024)
        if recall_target is None:
            # the global top-k spreads over the row blocks, so per-block
            # recall compounds in our favor when there are many blocks —
            # 0.95 keeps ~0.99 precision@100 at 8 blocks; few-block
            # (small) corpora need the higher per-block target.
            num_blocks = -(-matrix.num_rows // self.block_rows)
            recall_target = 0.95 if num_blocks >= 4 else 0.98
        self.recall_target = recall_target
        self.device = device or jax.devices()[0]

        padded_rows = -(-matrix.num_rows // self.block_rows) * self.block_rows
        self._elt_bytes = 1 if dtype == "int8" else 2
        dense_bytes = self._elt_bytes * padded_rows * matrix.num_cols
        budget = hbm_budget_bytes
        if budget is None:
            try:  # stay under ~60% of the device's memory when known
                stats = self.device.memory_stats()
                budget = int(stats["bytes_limit"] * 0.6)
            except Exception:
                budget = None
        if budget is not None and dense_bytes > budget:
            raise ValueError(
                f"dense form needs {dense_bytes/1e9:.1f} GB > budget "
                f"{budget/1e9:.1f} GB — use the sparse TopKSpMV engine")

        # exact rescoring (same semantics as TopKSpMV): keep the host CSR
        # and re-rank the top max(k, pool) bf16/approx_max_k candidates
        # with exact f32 dot products
        self._scipy_csr = (matrix.to_scipy_csr() if config.rescore_pool
                           else None)

        pad_rows = (-matrix.num_rows) % self.block_rows
        if dtype == "int8":
            bits, scales = densify_int8(matrix)
            if pad_rows:
                bits = np.concatenate(
                    [bits, np.zeros((pad_rows, bits.shape[1]), np.int8)])
                scales = np.concatenate(
                    [scales, np.ones(pad_rows, np.float32)])
            self._A = jax.device_put(bits, self.device)
            self._scales = jax.device_put(scales, self.device)
            return
        self._scales = None
        bits = densify_bf16(matrix)
        if pad_rows:
            bits = np.concatenate(
                [bits, np.zeros((pad_rows, bits.shape[1]), np.uint16)])
        self._A = jax.jit(
            lambda b: jax.lax.bitcast_convert_type(b, jnp.bfloat16)
        )(jax.device_put(bits, self.device))

    def query_batch(self, queries, k: Optional[int] = None):
        """(Q, C) queries -> (indices, values) of shape (Q, k)."""
        user_k = k or self.config.k
        pool = self.config.rescore_pool
        k = max(user_k, pool) if pool else user_k
        queries = np.asarray(queries, np.float32)
        num_real = (self.num_rows if self._A.shape[0] > self.num_rows
                    else None)
        if self.dtype == "int8":
            qdev, qscales = quantize_queries_int8(queries)
            idx, vals = dense_topk_batch(
                self._A, qdev, num_real, self._scales, qscales, k=k,
                block_rows=self.block_rows,
                recall_target=self.recall_target)
        else:
            idx, vals = dense_topk_batch(
                self._A, jnp.asarray(queries), num_real, k=k,
                block_rows=self.block_rows,
                recall_target=self.recall_target)
        # only when k exceeds the number of real rows can pad entries
        # surface; mark them
        idx = jnp.where(idx < self.num_rows, idx, -1)
        if pool:
            from ..api import exact_rescore

            outs = [exact_rescore(self._scipy_csr, np.asarray(idx[q]),
                                  queries[q], user_k)
                    for q in range(len(queries))]
            return (jnp.stack([jnp.asarray(o[0]) for o in outs]),
                    jnp.stack([jnp.asarray(o[1]) for o in outs]))
        return idx, vals

    def query(self, vec, k: Optional[int] = None):
        """Single query — provided for API parity; the dense sweep cost is
        per batch, so prefer query_batch for throughput."""
        idx, vals = self.query_batch(np.asarray(vec)[None, :], k)
        return idx[0], vals[0]

    @property
    def hbm_bytes(self) -> int:
        return int(np.prod(self._A.shape)) * self._elt_bytes
