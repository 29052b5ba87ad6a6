"""User-facing facade: matrix-resident Top-K SpMV engine.

Mirrors the lifecycle of the reference's `SpMV` struct
(/root/reference/src/fpga/src/host_spmv_bscsr.cpp:79-485):

  reference                      | here
  -------------------------------+------------------------------------------
  SpMV ctor: partition + BS-CSR  | TopKSpMV(matrix, config): SELL pack +
  pack + OpenCL buffer setup     | device_put (matrix stays HBM-resident)
  reset(vec): re-upload query    | nothing to do — the query is a plain
  (host_spmv_bscsr.cpp:450-484)  | argument, uploaded per call (~KB)
  operator()(): enqueue 8 CUs    | query(vec): one jitted sweep over the
                                 | per-bucket word arrays (ops/sweep.py)
  read_result(): host merge      | finalize_topk on device (lax.top_k)
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import LANES, TopKSpMVConfig, DEFAULT_CONFIG
from .formats.coo import CooMatrix
from .formats.sell_buckets import (BucketedSellMatrix, SellBucket,
                                   pack_sell_buckets)
from .ops.sweep import scores_device, topk_query


def exact_rescore(csr, idx, vec, k):
    """Exact top-k among candidate rows `idx` by f32 CSR dot products.

    csr: scipy CSR of the full matrix; idx: candidate rows (−1 = padding);
    returns (indices, values) of length k, sorted descending, padded with
    (−1, −inf) if fewer than k valid candidates.

    Hot path of the serving loop: a direct gather over (indptr, indices,
    data) — scipy's `csr[rows]` fancy indexing materializes a new sparse
    matrix and costs ~0.5 ms for a 400-row pool vs ~30 us here."""
    idx = np.asarray(idx)
    # dedupe: when the requested pool exceeds the valid candidate count,
    # masked (-inf) merge slots surface row ids that alias real candidates
    rows = np.unique(idx[idx >= 0]).astype(np.int64)
    vec = np.ascontiguousarray(vec, np.float32)
    out_i = np.full(k, -1, np.int32)
    out_v = np.full(k, -np.inf, np.float32)
    if len(rows) == 0:
        return out_i, out_v
    # normalize the CSR arrays once per matrix (scipy may hold int32
    # indptr / f64 data); cached on the csr object
    cache = getattr(csr, "_spmv_norm", None)
    if cache is None:
        cache = (np.ascontiguousarray(csr.indptr, np.int64),
                 np.ascontiguousarray(csr.indices, np.int32),
                 np.ascontiguousarray(csr.data, np.float32))
        csr._spmv_norm = cache
    indptr, indices, data = cache

    from .utils import native

    exact = native.csr_rescore(indptr, indices, data, vec, rows)
    if exact is None:  # NumPy fallback (differential oracle in tests)
        starts = indptr[rows]
        lens = indptr[rows + 1] - starts
        offs = np.concatenate(([0], np.cumsum(lens[:-1])))
        total = int(offs[-1] + lens[-1])
        gather = (np.arange(total, dtype=np.int64)
                  - np.repeat(offs, lens) + np.repeat(starts, lens))
        prod = data[gather] * vec[indices[gather]]
        # segment sums via cumsum difference (robust to zero-length rows,
        # unlike np.add.reduceat)
        csum = np.concatenate(([0.0], np.cumsum(prod, dtype=np.float64)))
        exact = (csum[offs + lens] - csum[offs]).astype(np.float32)
    order = np.argsort(-exact, kind="stable")[:k]
    out_i[: len(order)] = rows[order]
    out_v[: len(order)] = exact[order]
    return out_i, out_v


class TopKSpMV:
    """Matrix-resident approximate Top-K SpMV engine (single device).

    For multi-device / multi-host operation see
    spmv_topk.parallel.ShardedBucketedTopKSpMV.
    """

    def __init__(
        self,
        matrix,
        config: TopKSpMVConfig = DEFAULT_CONFIG,
        device: Optional[jax.Device] = None,
    ):
        if not isinstance(matrix, CooMatrix):
            from .formats.coo import from_scipy

            matrix = from_scipy(matrix)
        if config.max_cols < matrix.num_cols:
            import dataclasses

            config = dataclasses.replace(
                config, max_cols=-(-matrix.num_cols // LANES) * LANES
            )
        self._scipy_csr = None
        if config.rescore_pool:
            # keep the exact matrix host-side for candidate re-ranking.
            # Wrap the (data, indices, indptr) triple directly: scipy's
            # COO->CSR conversion materializes a full copy (~20 GB at 2G
            # nnz), while the sorted COO's arrays can back the CSR as-is
            # (duplicate (row, col) entries stay separate — the rescore
            # dot sums them, same semantics).
            self._scipy_csr = matrix.to_scipy_csr()
        self._setup(pack_sell_buckets(matrix, config), config, device)

    def _setup(self, sell: BucketedSellMatrix, config: TopKSpMVConfig,
               device: Optional[jax.Device]):
        """Put the packed buckets on the device (the matrix stays resident;
        each query is a plain argument)."""
        self.config = config
        self.sell = sell
        self.num_rows = sell.num_rows
        self.num_cols = sell.num_cols
        self.num_nnz = sell.num_nnz
        self.device = device or jax.devices()[0]
        self._value_scale = sell.value_scale
        self._words = tuple(jax.device_put(b.words, self.device)
                            for b in sell.buckets)
        self._row_ids = jax.device_put(sell.row_ids, self.device)
        self._valid = jax.device_put(sell.row_ids >= 0, self.device)

    def save(self, path: str) -> None:
        """Persist the packed engine (per-bucket words + row ids + config).

        The reference re-packs the matrix on every process start (SpMV
        ctor, host_spmv_bscsr.cpp:104-125); here packing a 20M-nnz corpus
        costs seconds, so serving deployments pack once and `load()` in
        the time it takes to read and device_put the buckets."""
        import dataclasses
        import json

        m = self.sell
        meta = dict(config=dataclasses.asdict(self.config),
                    num_rows=m.num_rows, num_cols=m.num_cols,
                    num_nnz=m.num_nnz, value_scale=m.value_scale,
                    format_version=3)
        arrays = {f"words_{i}": b.words for i, b in enumerate(m.buckets)}
        # explicit file handle: np.savez(str) appends '.npz' when the
        # suffix is missing, but load() opens the literal path
        with open(path, "wb") as fh:
            np.savez(fh, row_ids=m.row_ids, meta=np.frombuffer(
                json.dumps(meta).encode(), np.uint8), **arrays)

    @classmethod
    def load(cls, path: str, device: Optional[jax.Device] = None,
             matrix=None):
        """Reconstruct an engine saved with save(). query()/query_batch()/
        scores() all work on the loaded engine; exact rescoring needs the
        source matrix — pass it as `matrix=` (CooMatrix or scipy) to
        reattach the host CSR and keep the snapshot's rescore_pool armed,
        otherwise rescoring is disabled (see the warning below)."""
        z = np.load(path)
        meta, config = _load_meta(z["meta"])
        if config.rescore_pool and matrix is None:
            # the snapshot holds only the packed buckets, not the source
            # CSR the rescore needs — serve un-rescored rather than arm a
            # crash in the default query() path (pass matrix= to rescore)
            import dataclasses
            import warnings

            warnings.warn(
                "loaded engine has no host CSR: rescore_pool disabled "
                "(pass matrix= to load() to restore exact rescoring)",
                stacklevel=2)
            config = dataclasses.replace(config, rescore_pool=None)
        buckets, base = [], 0
        n_buckets = sum(1 for key in z.files if key.startswith("words_"))
        for i in range(n_buckets):
            w = z[f"words_{i}"]
            buckets.append(SellBucket(words=w, width=w.shape[1],
                                      slice_base=base))
            base += w.shape[0]
        sell = BucketedSellMatrix(
            buckets=buckets, row_ids=z["row_ids"],
            num_rows=meta["num_rows"], num_cols=meta["num_cols"],
            num_nnz=meta["num_nnz"], config=config,
            value_scale=meta["value_scale"])

        self = cls.__new__(cls)
        self._scipy_csr = None
        if matrix is not None and config.rescore_pool:
            if not isinstance(matrix, CooMatrix):
                from .formats.coo import from_scipy

                matrix = from_scipy(matrix)
            self._scipy_csr = matrix.to_scipy_csr()
        self._setup(sell, config, device)
        return self

    # -- query path ---------------------------------------------------------

    def _vector(self, vec) -> np.ndarray:
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != (self.num_cols,):
            raise ValueError(
                f"query must have shape ({self.num_cols},), got {vec.shape}"
            )
        return vec

    def _topk(self, x, k: int):
        """Device Top-`k` (indices, swept values) for a (C,) query or a
        (C, Q) query group. No extra jit wrapper around the engine:
        topk_query takes the word arrays as explicit arguments, so the
        (possibly GB-scale) corpus is never baked into the compiled
        program as a constant."""
        return topk_query(self._words, self._valid, self._row_ids,
                          jax.device_put(x, self.device),
                          codec=self.config.query_codec,
                          lane_k=self.config.lane_k, k=k)

    def _rescore(self, idx, vec, k):
        """Exact top-k among candidate rows `idx` by f32 CSR dot products.

        The device sweep (h16: 6-bit matrix values) proposes a pool of
        max(k, rescore_pool) rows; the true ranking is restored here with
        exact arithmetic — the same shape as the reference's host merge
        being the accuracy backstop over per-partition approximation
        (host_spmv_bscsr.cpp:399-448)."""
        if self._scipy_csr is None:
            raise NotImplementedError(
                "exact rescoring needs the host CSR: construct the engine "
                "from the matrix with config.rescore_pool set (load()ed "
                "snapshots do not carry it)")
        return exact_rescore(self._scipy_csr, idx, vec, k)

    def query(self, vec, k: Optional[int] = None,
              rescore_pool: Optional[int] = None):
        """Top-K rows by A @ vec: returns (indices, values), sorted desc.

        rescore_pool (default config.rescore_pool): when set, the device
        candidates are widened to max(k, rescore_pool) and exactly
        re-ranked on the host CSR — with the h16 codec this restores exact
        ranking while the sweep streams half the bytes."""
        k = k or self.config.k
        if rescore_pool is None:  # 0 disables explicitly
            rescore_pool = self.config.rescore_pool
        vec = self._vector(vec)
        pool = max(k, rescore_pool) if rescore_pool else k
        idx, vals = self._topk(vec, pool)
        if rescore_pool:
            ri, rv = self._rescore(np.asarray(idx), vec, k)
            # jax.Array return on every path (the rescore computes on host)
            return jnp.asarray(ri), jnp.asarray(rv)
        if self._value_scale != 1.0:
            vals = vals * self._value_scale
        return idx, vals

    def query_batch(self, queries, k: Optional[int] = None,
                    group_size: int = 8,
                    rescore_pool: Optional[int] = None):
        """Batched queries (Q, C) -> (Q, k) indices and values.

        The SpMM analog of multi_spmv_gold (gold_algorithms.hpp:21-35): the
        sweep reads each packed word once per group of `group_size`
        queries. rescore_pool: see query().
        """
        user_k = k or self.config.k
        if rescore_pool is None:  # 0 disables explicitly
            rescore_pool = self.config.rescore_pool
        k = max(user_k, rescore_pool) if rescore_pool else user_k
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.num_cols:
            raise ValueError(f"queries must have shape (Q, {self.num_cols}),"
                             f" got {queries.shape}")

        idx_all, val_all, futs = [], [], []
        pending = None  # previous group's device candidates (rescore mode)

        def _submit(idx_dev, q0, n):
            # Forcing the PREVIOUS group's candidates here overlaps its
            # host rescore with the current group's device sweep (the
            # reference overlaps readback the same way,
            # host_spmv_bscsr.cpp:354-397); the thread pool then re-ranks
            # the group's queries concurrently (native csr_rescore is
            # stateless and releases the GIL).
            arr = np.asarray(idx_dev)
            ex = self._rescore_executor()
            for j in range(n):
                futs.append(ex.submit(
                    self._rescore, arr[j], queries[q0 + j], user_k))

        for start in range(0, len(queries), group_size):
            chunk = queries[start:start + group_size]
            n_real = len(chunk)
            if n_real < group_size:  # pad the tail group (static shapes)
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], group_size - n_real, 0)])
            idx, vals = self._topk(np.ascontiguousarray(chunk.T), k)
            if rescore_pool:
                if pending is not None:
                    _submit(*pending)
                pending = (idx, start, n_real)
                continue
            idx_all.append(idx[:n_real])
            val_all.append(vals[:n_real] * self._value_scale)
        if rescore_pool:
            if pending is not None:
                _submit(*pending)
            outs = [f.result() for f in futs]
            return (jnp.stack([jnp.asarray(o[0]) for o in outs]),
                    jnp.stack([jnp.asarray(o[1]) for o in outs]))
        return jnp.concatenate(idx_all), jnp.concatenate(val_all)

    def _rescore_executor(self):
        return rescore_executor(self)

    def scores(self, vec) -> np.ndarray:
        """Full dense result A @ vec in original row order (no Top-K).

        The plain-SpMV path, parity with the reference's SpMV-only hosts
        (host_spmv_csr_gpu.cu:171-231): the sweep's score stage over the
        same buckets the Top-K path reads. Exact sums of the stored
        values (bf16 for f32, 6-bit for h16) times the f32 query.
        Materializes N floats — prefer query() for similarity lookup."""
        s = np.asarray(scores_device(
            self._words, jax.device_put(self._vector(vec), self.device),
            codec=self.config.query_codec))
        ids = self.sell.row_ids
        real = ids >= 0
        res = np.zeros(self.num_rows, np.float32)
        res[ids[real]] = s[real] * np.float32(self._value_scale)
        return res

    # -- accounting ---------------------------------------------------------

    @property
    def hbm_bytes(self) -> int:
        """Bytes of packed words streamed per sweep."""
        return self.sell.hbm_bytes

    @property
    def bytes_per_nnz(self) -> float:
        return self.hbm_bytes / max(self.num_nnz, 1)


def _load_meta(raw: np.ndarray):
    """(meta dict, TopKSpMVConfig) from a snapshot's JSON meta record."""
    import json

    from .config import ValueFormat

    meta = json.loads(bytes(raw).decode())
    cfg = dict(meta["config"])
    cfg["value_format"] = ValueFormat(**cfg["value_format"])
    return meta, TopKSpMVConfig(**cfg)


def rescore_executor(holder):
    """Lazily-created thread pool for batched host rescoring, cached on
    `holder` (an engine instance; shared with the sharded engine)."""
    ex = getattr(holder, "_rescore_ex", None)
    if ex is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(
            max_workers=min(16, os.cpu_count() or 8),
            thread_name_prefix="rescore")
        holder._rescore_ex = ex
    return ex
