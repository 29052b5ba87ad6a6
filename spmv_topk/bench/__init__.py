from .harness import (run_benchmark, BenchResult, CSV_HEADER,
                      device_step_seconds)
from .sweep import run_sweep
