"""Runtime configuration for the Top-K SpMV engines.

The reference design fixes everything at FPGA-synthesis time
(``/root/reference/src/common/types.hpp:20-79``: FIXED_WIDTH, K,
SPMV_PARTITIONS, BSCSR packet geometry, LIMITED_FINISHED_ROWS, ...).
Here there is no rebuild wall: all knobs live in one dataclass consumed
at ``jit``-trace time, so a config change costs a recompile (~seconds),
not an overnight place-and-route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# SELL-C slice height: each packed slice holds 128 rows, one per lane, so
# 128 consecutive words of a slice row are read by 128 consecutive threads.
# This replaces the reference's 512-bit HBM/AXI word (BSCSR_PORT_BITWIDTH,
# types.hpp:71).
LANES = 128


@dataclasses.dataclass(frozen=True)
class ValueFormat:
    """Reduced-precision storage format of matrix values.

    Mirrors the reference's fixed-point knobs (types.hpp:20-29:
    FIXED_WIDTH/SCALE ap_ufixed and the USE_FLOAT switch). The natural
    reduced format is bfloat16 (8-bit mantissa, exact conversion to f32);
    scaled fixed-point emulation is provided for numerical parity testing
    with the FPGA's ap_ufixed<W,1,AP_TRN_ZERO> arithmetic.
    """

    kind: str = "bf16"          # "f32" | "bf16" | "fixed"
    fixed_width: int = 32       # total bits of the emulated ap_ufixed
    fixed_integer_part: int = 1  # integer bits (reference uses 1)

    @property
    def scale(self) -> int:
        return self.fixed_width - self.fixed_integer_part

    @property
    def bytes_per_value(self) -> int:
        if self.kind == "f32":
            return 4
        if self.kind == "bf16":
            return 2
        return (self.fixed_width + 7) // 8


F32 = ValueFormat("f32")
BF16 = ValueFormat("bf16")
FIXED32 = ValueFormat("fixed", fixed_width=32)
# <=9 significant bits are exactly representable in the bf16 container, so
# FIXED8 gives bit-exact ap_ufixed<8,1> semantics end to end.
FIXED8 = ValueFormat("fixed", fixed_width=8)

# Column-field widths of the packed words (formats/sell_buckets.py).
_MAX_COLS = {"f32": 1 << 16, "h16": 1 << 10}


@dataclasses.dataclass(frozen=True)
class TopKSpMVConfig:
    """All design knobs of the sparse Top-K SpMV engine.

    Reference counterparts (file:line into /root/reference):
      - k: global Top-K requested by the user (options.hpp:28, default 20;
        benchmarks use 100).
      - lane_k: per-lane Top-K kept by the sweep. Plays the role of the
        per-partition K=8 (types.hpp:51) in the FPGA's argmin-replacement
        scheme, except the sweep keeps one buffer per SELL lane (128 per
        device), so recall at global K=100 is far higher for the same
        lane_k (see eval/accuracy_model.py).
      - value_format: reduced-precision storage (types.hpp:20-29).
      - max_cols: MAX_COLS (types.hpp:55).
      - sigma_sort: whether rows are degree-sorted before slicing
        (SELL-C-sigma); keeps slice padding negligible on skewed (gamma)
        degree distributions.
      - width_quantum: slice-width granularity of the degree buckets (8, 4,
        2 or 1; finer quanta cut width-quantization padding at the cost of
        more buckets, each a separately compiled sweep).
      - query_codec: packed word format. "f32" stores one nnz per 32-bit
        word (16-bit column + bf16 value); "h16" stores two nnz per word
        (10-bit column + 6-bit value halves with one global scale), which
        halves the bytes streamed per nnz. Both gather an f32 query.
      - rescore_pool: exact rescoring. Keep the host CSR at build time
        and, per query, re-rank the top max(k, rescore_pool) device
        candidates with exact f32 dot products. Restores exact ranking for
        the h16 codec's 6-bit values. The reference's analog is the host
        merge being the accuracy backstop for per-partition approximation
        (topk_errors.py:29-42).
    """

    k: int = 100
    lane_k: int = 8
    value_format: ValueFormat = BF16
    max_cols: int = 1024
    sigma_sort: bool = True
    width_quantum: int = 8
    query_codec: str = "f32"
    rescore_pool: Optional[int] = None

    def __post_init__(self):
        if self.max_cols % LANES != 0:
            raise ValueError(f"max_cols must be a multiple of {LANES}")
        if self.query_codec not in _MAX_COLS:
            raise ValueError(f"unknown query codec {self.query_codec!r} "
                             "(expected 'f32' or 'h16')")
        limit = _MAX_COLS[self.query_codec]
        if self.max_cols > limit:
            raise ValueError(f"{self.query_codec} codec supports max_cols "
                             f"<= {limit} (column field width)")
        if self.width_quantum not in (1, 2, 4, 8):
            raise ValueError("width_quantum must be 1, 2, 4 or 8")
        if self.lane_k < 1:
            raise ValueError("lane_k must be >= 1")


DEFAULT_CONFIG = TopKSpMVConfig()
