"""Profiling / tracing helpers.

The reference instruments every phase with std::chrono timers and OpenCL
event profiling (opencl_utils.hpp:331-361). The equivalents here:

  - `phase_timer`: wall-clock phase timing (host-side phases: pack, put).
  - `device_trace`: jax.profiler trace context (open in TensorBoard /
    xprof to see kernel timelines on the device).
  - `timed_slope`: per-iteration device time from the slope between
    short and long chained on-device iteration counts, so dispatch
    overhead cancels.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None, verbose: bool = False):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    if verbose:
        print(f"[{name}] {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def device_trace(log_dir: str):
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_slope(run_n, short: int, long_: int, reps: int = 5) -> float:
    """Per-iteration device time from the slope of two chained run lengths.

    run_n(n) must execute n chained device iterations and block until the
    result is on host (np.asarray). Returns seconds per iteration.

    Each slope pairs ADJACENT short/long runs and the median of reps
    rejects outliers.
    """
    run_n(short)
    run_n(long_)

    def once(n):
        t0 = time.perf_counter()
        run_n(n)
        return time.perf_counter() - t0

    slopes = sorted(
        (once(long_) - once(short)) / (long_ - short) for _ in range(reps))
    return slopes[len(slopes) // 2]


def enable_compilation_cache() -> None:
    """Persistent executable cache for the program's entry points.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it at import
    and that directory is the only cache used. Otherwise the cache is
    `<repo>/.jax_cache`: a fixed path, so every entry point (bench.py,
    chip_smoke.py, the CLI) shares one cache regardless of cwd.

    CPU backends are excluded: XLA:CPU executables are keyed without the
    host's CPU feature set, so an artifact cached on one machine can crash
    when loaded on another. Safe to call multiple times."""
    import os

    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if str(jax.config.jax_platforms or "").startswith("cpu"):
        return
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
