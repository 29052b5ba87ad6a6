"""Reduced-precision value quantization.

Emulates the reference's fixed-point matrix storage
(/root/reference/src/common/types.hpp:20-27 and
``real_type = ap_ufixed<FIXED_WIDTH, FIXED_INTEGER_PART, AP_TRN_ZERO>``,
/root/reference/src/fpga/src/ip/fpga_types.hpp:16-23): unsigned fixed point
with SCALE fractional bits and truncate-toward-zero conversion.

The quantization is applied at pack time ("fake quant"): values are
quantized then stored in the compute dtype, which reproduces the FPGA's
arithmetic on its inputs exactly while the sweep itself runs in f32/bf16.
"""

from __future__ import annotations

import numpy as np

from ..config import ValueFormat


def quantize_fixed(vals: np.ndarray, width: int, integer_part: int = 1) -> np.ndarray:
    """ap_ufixed<width, integer_part, AP_TRN_ZERO> rounding, as float32."""
    scale = float(1 << (width - integer_part))
    limit = float(1 << integer_part)
    v = np.clip(vals, 0.0, limit - 1.0 / scale)
    # AP_TRN_ZERO truncates toward zero.
    return (np.trunc(v.astype(np.float64) * scale) / scale).astype(np.float32)


def quantize_bf16(vals: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even bfloat16, returned as float32."""
    bits = np.ascontiguousarray(vals, dtype=np.float32).view(np.uint32)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = rounded.view(np.float32).copy()
    nan = np.isnan(vals)
    if np.any(nan):
        out[nan] = np.nan
    return out


def bf16_bits(vals: np.ndarray) -> np.ndarray:
    """bfloat16 bit pattern (uint16) of float32 values, round-to-nearest-even."""
    return (
        np.ascontiguousarray(quantize_bf16(vals), dtype=np.float32)
        .view(np.uint32) >> 16
    ).astype(np.uint16)


def quantize(vals: np.ndarray, fmt: ValueFormat) -> np.ndarray:
    if fmt.kind == "f32":
        return np.asarray(vals, dtype=np.float32)
    if fmt.kind == "bf16":
        return quantize_bf16(vals)
    if fmt.kind == "fixed":
        return quantize_fixed(vals, fmt.fixed_width, fmt.fixed_integer_part)
    raise ValueError(f"unknown value format {fmt.kind!r}")
