"""Test configuration: run on a simulated 8-device CPU mesh.

The tests pin the CPU backend (``JAX_PLATFORMS=cpu``); multi-device
sharding logic is validated on 8 virtual CPU devices. The GPU path is
exercised by ``chip_smoke.py``. Set env BEFORE importing jax anywhere.
"""

import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
# the tests' own compile-cache directory: a fixed name under this run's
# temp dir (metagraph_tpu sets none in code when this variable is set)
os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
    tempfile.gettempdir(), "metagraph_xla_cache_cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

# pin the config too, in case a plugin imported jax before this file ran
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

REFERENCE_DATA = "/root/reference/metagraph/tests/data"


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """XLA:CPU's compiler intermittently segfaults (roaming across
    modules, e.g. ranksel's search programs) once hundreds of compiled
    executables from earlier modules are resident in the process —
    full-suite runs only; every bisected subset passes. Dropping the
    jit/compile caches at each module boundary keeps the compiler within
    tested territory at the cost of some recompiles."""
    import jax
    jax.clear_caches()
    yield


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_dna(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
