"""spmv-topk: approximate Top-K SpMV for sparse embedding similarity
(JAX).

Brand-new implementation of the capabilities of the DAC'21 FPGA design
AlbertoParravicini/approximate-spmv-topk (see SURVEY.md): a packed,
reduced-precision streaming Top-K SpMV over sparse embedding matrices,
row-sharded across devices with a collective Top-K merge.
"""

from .config import (
    TopKSpMVConfig, ValueFormat, DEFAULT_CONFIG, F32, BF16, FIXED32, FIXED8,
    LANES,
)
from .api import TopKSpMV
from .ops.dense import DenseTopKSpMV

__version__ = "0.1.0"
