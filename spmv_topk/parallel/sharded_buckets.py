"""Row-sharded Top-K SpMV on the bucketed layout.

shard_map runs one program on every device, so the per-device bucket
structure must be identical. Shards of the same corpus have near-identical
degree profiles, so a *common bucket skeleton* costs little padding:

  1. rows are split into contiguous equal blocks per device (the
     reference's partition rule, host_spmv_bscsr.cpp:136-141);
  2. each shard is SELL-bucket-packed independently;
  3. the skeleton is the union of bucket widths, each with its slice
     count maxed across devices; a shard's missing slices are zero words
     whose row ids are -1, and the sweep masks every -1 lane;
  4. per-device row_ids map skeleton slice positions to global rows.

The merge is unchanged: per-device local Top-K -> all_gather of k
(value, row) pairs over the device interconnect -> replicated lax.top_k.

Multi-process (multi-HOST) operation: each process packs ONLY the rows
owned by its addressable devices (pass ``local_rows=(row_lo,
global_num_rows)`` with a matrix holding just this process's row slice —
the generalization of the reference's per-partition packing,
host_spmv_bscsr.cpp:136-150). The bucket-width skeleton and the h16 value
scale are agreed across processes with one small ``process_allgather``;
the global device arrays are assembled from per-process shards via
``jax.make_array_from_single_device_arrays`` so no host ever materializes
another host's shard. Exact rescoring keeps only the local CSR slice per
host and merges candidate scores across processes (the distributed analog
of the host merge, host_spmv_bscsr.cpp:399-448).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LANES, TopKSpMVConfig, DEFAULT_CONFIG
from ..formats.coo import CooMatrix
from ..formats.sell_buckets import pack_sell_buckets
from ..ops.sweep import finalize_topk, lane_topk, sweep_scores
from .mesh import AXIS, make_mesh

_SKELETON_SLOTS = 256  # fixed-size allgather payload: (width, slices) pairs


def _process_allgather(x: np.ndarray) -> np.ndarray:
    """All processes' copies of x, stacked on axis 0 (process order)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(
        np.asarray(x), tiled=False))


class ShardedBucketedTopKSpMV:
    """Multi-device engine on the bucketed layout (single or multi host)."""

    def __init__(
        self,
        matrix: CooMatrix,
        config: TopKSpMVConfig = DEFAULT_CONFIG,
        mesh: Optional[Mesh] = None,
        local_rows: Optional[tuple] = None,
        exchange_skeleton: Optional[bool] = None,
    ):
        """local_rows: ``(row_lo, global_num_rows)`` — `matrix` holds only
        this process's contiguous row slice starting at global row
        ``row_lo`` of a ``global_num_rows``-row corpus. Required shape for
        multi-host serving (each host packs its own rows); None means
        `matrix` is the full corpus (single process, or every process
        loaded it).

        exchange_skeleton: force the multi-process skeleton/scale
        exchange even single-process (None = auto: processes > 1); used
        by dry runs to execute the multi-host code path on one process.
        """
        if not config.sigma_sort:
            raise ValueError(
                "sharded engines need sigma_sort=True: the cross-shard "
                "bucket skeleton keys buckets by width, and unsorted rows "
                "produce several buckets of one width")
        self._setup_mesh(mesh, config)
        mesh = self.mesh
        D = int(mesh.devices.size)
        nproc = jax.process_count()
        exchange = (nproc > 1 if exchange_skeleton is None
                    else bool(exchange_skeleton))
        self.num_cols = matrix.num_cols

        if not matrix.is_sorted_row_major():
            matrix = matrix.sort_row_major()

        if local_rows is None:
            row_lo, global_rows = 0, matrix.num_rows
        else:
            row_lo, global_rows = int(local_rows[0]), int(local_rows[1])
        self.num_rows = global_rows
        rows_per_shard = -(-global_rows // D)
        my_pos = self._my_pos

        # Rescore keeps only the LOCAL row slice of the CSR per host.
        self._csr_lo = my_pos[0] * rows_per_shard
        self._csr_hi = min((my_pos[-1] + 1) * rows_per_shard, global_rows)
        if config.rescore_pool:
            if local_rows is None and nproc == 1:
                self._scipy_csr = matrix.to_scipy_csr()
                self._csr_lo, self._csr_hi = 0, global_rows
            else:
                self._scipy_csr = matrix.row_slice(
                    self._csr_lo - row_lo,
                    self._csr_hi - row_lo).to_scipy_csr()
        else:
            self._scipy_csr = None

        # h16 quantizes values with ONE global scale so per-shard scores
        # stay comparable across devices at the merge.
        self._value_scale = 1.0
        vscale = None
        if config.query_codec == "h16":
            vmax = float(np.max(np.abs(matrix.vals))) if matrix.nnz else 0.0
            if exchange:
                vmax = float(_process_allgather(
                    np.float32(vmax)).max())
            vscale = ((vmax or 1.0) / 31.0) or 1.0
            self._value_scale = vscale

        # Pack only this process's shards.
        packs = []  # per local device: (global row of its first row, pack)
        for pos in my_pos:
            lo = pos * rows_per_shard
            hi = min(lo + rows_per_shard, global_rows)
            if not (row_lo <= lo and hi <= row_lo + matrix.num_rows):
                raise ValueError(
                    f"device shard rows [{lo},{hi}) outside this process's "
                    f"matrix rows [{row_lo},{row_lo + matrix.num_rows}) — "
                    "pass the slice from distributed.local_shard_rows")
            local = matrix.row_slice(lo - row_lo, hi - row_lo)
            if local.num_rows <= 0 or local.nnz == 0:
                raise ValueError(f"shard {pos} is empty ({D} devices)")
            packs.append((lo, pack_sell_buckets(local, config,
                                                value_scale=vscale)))

        # Common skeleton: widths sorted descending (each shard's own
        # order), slice counts maxed across ALL shards of ALL processes.
        # Every device then holds the same bucket shapes -> one compiled
        # sweep under shard_map.
        by_width: dict[int, int] = {}
        for _, m in packs:
            for b in m.buckets:
                by_width[b.width] = max(by_width.get(b.width, 0),
                                        b.num_slices)
        if exchange:
            # Fixed-size payload: (width, slices) pairs, zero-padded.
            pairs = np.zeros((_SKELETON_SLOTS, 2), np.int64)
            items = sorted(by_width.items(), reverse=True)
            if len(items) > _SKELETON_SLOTS:
                raise ValueError(f"{len(items)} bucket widths exceed the "
                                 f"{_SKELETON_SLOTS}-slot skeleton exchange")
            for i, (w, n) in enumerate(items):
                pairs[i] = (w, n)
            allp = _process_allgather(pairs).reshape(-1, 2)
            by_width = {}
            for w, n in allp[allp[:, 0] > 0]:
                by_width[int(w)] = max(by_width.get(int(w), 0), int(n))
        skeleton = [(w, by_width[w]) for w in sorted(by_width, reverse=True)]
        total_slices = sum(n for _, n in skeleton)

        shard_words, shard_rows = [], []
        for row0, m in packs:
            have = {b.width: b for b in m.buckets}
            words, base = [], 0
            rid = np.full((total_slices, LANES), -1, np.int32)
            for w, n in skeleton:
                buf = np.zeros((n, w, LANES), np.int32)
                b = have.get(w)
                if b is not None:
                    buf[:b.num_slices] = b.words
                    ids = m.row_ids[b.slice_base:
                                    b.slice_base + b.num_slices].copy()
                    ids[ids >= 0] += row0
                    rid[base:base + b.num_slices] = ids
                words.append(buf)
                base += n
            shard_words.append(words)
            shard_rows.append(rid)

        self._finalize(skeleton, shard_words, shard_rows)

    # ------------------------------------------------------------------

    def _setup_mesh(self, mesh, config):
        if mesh is None:
            if jax.process_count() > 1:
                from .distributed import global_mesh

                mesh = global_mesh()
            else:
                mesh = make_mesh()
        self.mesh = mesh
        self.config = config
        # Merge width: widened to the rescore pool so the host re-ranking
        # has enough exact candidates (see api.TopKSpMV._rescore).
        self._merge_k = max(config.k, config.rescore_pool or 0)
        me = jax.process_index()
        self._flat_devices = list(self.mesh.devices.flat)
        self._my_pos = [i for i, d in enumerate(self._flat_devices)
                        if d.process_index == me]
        if not self._my_pos:
            raise ValueError(f"process {me} owns no devices of the mesh")

    def _finalize(self, skeleton, shard_words, shard_rows):
        """Assemble the global device arrays from per-process single-device
        shards: no host ever holds (D, ...) — only its own
        (len(my_pos), ...) slices."""
        D = int(self.mesh.devices.size)
        self.skeleton = skeleton
        flat, my_pos = self._flat_devices, self._my_pos

        def _global(shards):
            spec = NamedSharding(self.mesh, P(AXIS))
            bufs = [jax.device_put(s[None], flat[pos])
                    for pos, s in zip(my_pos, shards)]
            return jax.make_array_from_single_device_arrays(
                (D,) + shards[0].shape, spec, bufs)

        self._words = tuple(_global([sw[i] for sw in shard_words])
                            for i in range(len(skeleton)))
        self._row_ids = _global(shard_rows)
        self._valid = _global([r >= 0 for r in shard_rows])
        self._query_fn = self._build_query_fn()

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        """Per-shard snapshot: `{path}.meta.npz` (process 0) plus one
        `{path}.shard{pos:04d}.npz` per device position, each written by
        the process owning that device — no host materializes another
        host's shard. Amortizes the pack cost the reference pays every
        process start (SpMV ctor, host_spmv_bscsr.cpp:104-125). The
        rescore CSR is NOT persisted (it is the raw matrix); pass the
        local matrix slice to load() to restore exact rescoring without
        repacking."""
        import dataclasses
        import json

        if jax.process_index() == 0:
            meta = dict(config=dataclasses.asdict(self.config),
                        skeleton=self.skeleton,
                        num_devices=int(self.mesh.devices.size),
                        num_rows=self.num_rows, num_cols=self.num_cols,
                        value_scale=self._value_scale, format_version=2)
            with open(f"{path}.meta.npz", "wb") as fh:
                np.savez(fh, meta=np.frombuffer(
                    json.dumps(meta).encode(), np.uint8))
        # addressable_shards order is unspecified: key each shard by the
        # mesh position of its device, not by list order
        pos_of_dev = {d.id: pos
                      for pos, d in enumerate(self._flat_devices)}

        def by_pos(arr):
            return {pos_of_dev[s.device.id]: np.asarray(s.data)[0]
                    for s in arr.addressable_shards}

        words = [by_pos(w) for w in self._words]
        rids = by_pos(self._row_ids)
        for pos in self._my_pos:
            with open(f"{path}.shard{pos:04d}.npz", "wb") as fh:
                np.savez(fh, row_ids=rids[pos],
                         **{f"words_{i}": w[pos] for i, w in enumerate(words)})

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None,
             matrix: Optional[CooMatrix] = None,
             local_rows: Optional[tuple] = None):
        """Reconstruct a sharded engine from save(): each process reads
        ONLY its own devices' shard files (multi-process load). The mesh
        may have a different process layout than at save time, but must
        have the same device count.

        matrix (+ local_rows, same contract as __init__): optional source
        rows to rebuild the host rescore CSR from — without it a
        rescore_pool config degrades to un-rescored serving with a
        warning, like TopKSpMV.load."""
        from ..api import _load_meta

        meta, config = _load_meta(np.load(f"{path}.meta.npz")["meta"])
        self = cls.__new__(cls)
        self._setup_mesh(mesh, config)
        D = int(self.mesh.devices.size)
        if D != int(meta["num_devices"]):
            raise ValueError(
                f"snapshot was saved for {meta['num_devices']} devices, "
                f"mesh has {D}")
        self.num_rows = int(meta["num_rows"])
        self.num_cols = int(meta["num_cols"])
        self._value_scale = float(meta["value_scale"])

        rows_per_shard = -(-self.num_rows // D)
        self._csr_lo = self._my_pos[0] * rows_per_shard
        self._csr_hi = min((self._my_pos[-1] + 1) * rows_per_shard,
                           self.num_rows)
        self._scipy_csr = None
        if config.rescore_pool:
            if matrix is None:
                import warnings

                warnings.warn(
                    "loaded sharded engine has no host CSR: rescore_pool "
                    "disabled (pass matrix= to load() to restore exact "
                    "rescoring)", stacklevel=2)
            else:
                row_lo = int(local_rows[0]) if local_rows else 0
                self._scipy_csr = matrix.row_slice(
                    self._csr_lo - row_lo,
                    self._csr_hi - row_lo).to_scipy_csr()

        skeleton = [tuple(e) for e in meta["skeleton"]]
        shard_words, shard_rows = [], []
        for pos in self._my_pos:
            s = np.load(f"{path}.shard{pos:04d}.npz")
            shard_words.append([s[f"words_{i}"]
                                for i in range(len(skeleton))])
            shard_rows.append(s["row_ids"])
        self._finalize(skeleton, shard_words, shard_rows)
        return self

    # ------------------------------------------------------------------

    def _build_query_fn(self):
        """One jitted program: every device sweeps its shard, reduces to
        its local top merge_k, all_gathers the (value, row) pairs and takes
        the replicated global top merge_k. Handles a (C,) query and a
        (C, Q) query group (Q-leading outputs)."""
        k = self._merge_k
        cfg = self.config

        def local_fn(row_ids, valid, x, *words):
            scores = sweep_scores(tuple(w[0] for w in words), x,
                                  cfg.query_codec)
            topv, topt = lane_topk(scores, valid[0], cfg.lane_k)
            if x.ndim == 1:
                lr, lv = finalize_topk(topv, topt, row_ids[0], k)
                gr = jax.lax.all_gather(lr, AXIS).reshape(-1)
                gv = jax.lax.all_gather(lv, AXIS).reshape(-1)
                fv, fpos = jax.lax.top_k(gv, min(k, gv.shape[0]))
                return gr[fpos], fv
            lr, lv = jax.vmap(
                lambda v, t: finalize_topk(v, t, row_ids[0], k))(topv, topt)
            gr = jax.lax.all_gather(lr, AXIS, axis=1)   # (Q, D, k)
            gv = jax.lax.all_gather(lv, AXIS, axis=1)
            gvf = gv.reshape(gv.shape[0], -1)
            fv, fpos = jax.lax.top_k(gvf, min(k, gvf.shape[1]))
            fr = jnp.take_along_axis(gr.reshape(gr.shape[0], -1), fpos,
                                     axis=1)
            return fr, fv

        n = len(self.skeleton)
        fn = jax.shard_map(
            local_fn,
            mesh=self.mesh,
            in_specs=(P(AXIS), P(AXIS), P()) + (P(AXIS),) * n,
            # identical on every device -> replicated output
            out_specs=(P(), P()),
            check_vma=False,
        )
        return jax.jit(fn)

    def _run(self, x: np.ndarray):
        return self._query_fn(self._row_ids, self._valid, jnp.asarray(x),
                              *self._words)

    def _rescore_global(self, idx: np.ndarray, vec: np.ndarray, k: int):
        """Exact re-rank of merged candidates against the per-host CSR
        slice, combined across processes (distributed read_result,
        host_spmv_bscsr.cpp:399-448)."""
        from ..api import exact_rescore

        idx = np.asarray(idx).reshape(-1)
        local = idx[(idx >= self._csr_lo) & (idx < self._csr_hi)]
        li, lv = exact_rescore(self._scipy_csr, local - self._csr_lo,
                               vec, k)
        li = np.where(li >= 0, li + self._csr_lo, -1).astype(np.int32)
        if jax.process_count() > 1:
            gi = _process_allgather(li).reshape(-1)
            gv = _process_allgather(lv).reshape(-1)
            order = np.argsort(-gv, kind="stable")[:k]
            li, lv = gi[order].astype(np.int32), gv[order]
        return jnp.asarray(li), jnp.asarray(lv)

    def _check_k(self, k):
        if k > self._merge_k:
            raise ValueError(
                f"k={k} exceeds the build-time merge width "
                f"{self._merge_k} (config.k={self.config.k}; "
                f"config.rescore_pool widens it)")

    def query(self, vec, k: Optional[int] = None):
        k = k or self.config.k
        self._check_k(k)
        vec = np.asarray(vec, dtype=np.float32)
        idx, vals = self._run(vec)
        if self._scipy_csr is not None:
            return self._rescore_global(np.asarray(idx), vec, k)
        if self._value_scale != 1.0:
            vals = vals * self._value_scale
        return idx[:k], vals[:k]

    def query_batch(self, queries, k: Optional[int] = None,
                    group_size: int = 8):
        """Batched sharded queries: the sweep reads each word once per
        group and the merge gathers (Q, k) candidate pairs per device."""
        kk = k or self.config.k
        self._check_k(kk)
        queries = np.asarray(queries, dtype=np.float32)
        rescore = self._scipy_csr is not None
        # Single-process: overlap the host rescore with the next group's
        # device sweep on a thread pool (api.TopKSpMV.query_batch does the
        # same). Multi-process rescore issues process_allgather collectives
        # whose ORDER must match on every host, so it stays serial there.
        threaded = rescore and jax.process_count() == 1
        idx_all, val_all, futs = [], [], []
        pending = None

        def _submit(idx_dev, chunk, n):
            from ..api import rescore_executor

            arr = np.asarray(idx_dev)
            ex = rescore_executor(self)
            for q in range(n):
                futs.append(ex.submit(
                    self._rescore_global, arr[q], chunk[q], kk))

        for start in range(0, len(queries), group_size):
            chunk = queries[start:start + group_size]
            n_real = len(chunk)
            if n_real < group_size:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], group_size - n_real, 0)])
            idx, vals = self._run(np.ascontiguousarray(chunk.T))
            if threaded:
                if pending is not None:
                    _submit(*pending)
                pending = (idx, chunk, n_real)
                continue
            if rescore:
                outs = [self._rescore_global(np.asarray(idx[q]), chunk[q], kk)
                        for q in range(n_real)]
                idx_all.append(jnp.stack([o[0] for o in outs]))
                val_all.append(jnp.stack([o[1] for o in outs]))
                continue
            idx_all.append(idx[:n_real, :kk])
            val_all.append(vals[:n_real, :kk] * self._value_scale)
        if threaded:
            if pending is not None:
                _submit(*pending)
            outs = [f.result() for f in futs]
            return (jnp.stack([jnp.asarray(o[0]) for o in outs]),
                    jnp.stack([jnp.asarray(o[1]) for o in outs]))
        return jnp.concatenate(idx_all), jnp.concatenate(val_all)

    @property
    def hbm_bytes(self) -> int:
        return sum(int(np.prod(w.shape)) * 4 for w in self._words)
