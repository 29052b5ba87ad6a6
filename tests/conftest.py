"""Test configuration: CPU JAX with a virtual 8-device mesh by default.

Sharding/multi-host behavior is tested without accelerators via
xla_force_host_platform_device_count, the analog of the reference's sw_emu
Vitis target (functional emulation without the card, Makefile:114-138).

Tests marked `gpu` need an NVIDIA GPU; the `gpu` fixture decides at run
time and skips them elsewhere. `python chip_smoke.py` runs them on the
card in its own process (or: JAX_PLATFORMS=cuda python -m pytest tests
-m gpu).
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["XLA_FLAGS"] = _flags


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test when JAX runs on another
    backend."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on the "
                    "card)")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The suite compiles hundreds of distinct XLA:CPU programs in one
    process; with all of them kept loaded, a later LLVM JIT compile can
    segfault (observed deterministically at ~80 programs on jax 0.9.0,
    always inside backend_compile_and_load). Dropping the jit executable
    caches between modules keeps the resident JIT state small.
    """
    yield
    import jax

    jax.clear_caches()
