"""Test configuration: run the whole suite on a virtual 8-device CPU mesh
with float64 enabled, so multi-device sharding paths compile and execute
without accelerator hardware (SURVEY.md §4 — the reference's tests are
serial; we add the missing distributed dimension by running the identical
suite on the virtual mesh).

``JAX_PLATFORMS`` (default ``cpu``) selects the backend; the tests marked
``gpu`` need ``JAX_PLATFORMS=cuda,cpu`` on a machine with a GPU and skip
elsewhere."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(42)


# The four scalar flavors of the reference (rsp/rdp/csp/cdp) —
# include/common.fypp kind lists.
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.fixture(params=DTYPES, ids=["rsp", "rdp", "csp", "cdp"])
def dtype(request):
    return request.param


@pytest.fixture(params=[np.float64, np.complex128], ids=["rdp", "cdp"])
def dtype_dp(request):
    return request.param


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips with a reason elsewhere)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none (decided at
    run time, never at import, so every worker collects the same tests)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {devs[0].platform}")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Work around an XLA-CPU compiler crash (jax 0.9.0): after a few
    hundred in-process compilations the NEXT `backend_compile_and_load`
    segfaults/aborts inside LLVM, regardless of which computation is being
    compiled (reproduced at the same global compile ordinal with the
    offending test moved, reordered, and with
    --xla_cpu_parallel_codegen_split_count=1).  Dropping the executable
    caches between test modules keeps the in-process compilation state
    below the trigger threshold; the cost is per-module recompilation of
    shared helpers."""
    yield
    jax.clear_caches()
