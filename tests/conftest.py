"""Test configuration.

The suite runs on the CPU backend, on a virtual 8-device mesh (the env
mesh paths see 8 devices as they would see 8 cards), with x64 enabled so
the engine can be checked tightly against the C MuJoCo oracle.

Tests marked ``gpu`` need a card. Each asks the ``gpu`` fixture inside the
test, so every worker collects the same tests, and skips on the CPU.
``python chip_smoke.py`` runs them on the card with
``JAX_PLATFORMS=cuda,cpu``, the one case in which the suite leaves the CPU.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
        # single-threaded LLVM codegen: the parallel split path segfaults
        # nondeterministically in backend_compile_and_load (jax 0.9.0,
        # ~once/15min of compiles; observed across 4 suite runs)
        + " --xla_cpu_parallel_codegen_split_count=1"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

from mujoco_sim_tpu.utils.cache import use_compile_cache  # noqa: E402

# robot-scale step programs are minutes of XLA:CPU compile each; re-runs
# of the suite hit the persistent cache instead
use_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips on the CPU, run by chip_smoke.py")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (python chip_smoke.py runs it on the card)")
    return jax.devices()[0]
