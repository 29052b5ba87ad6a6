from . import gold, fixedpoint, xla_ref
from .sweep import finalize_topk
