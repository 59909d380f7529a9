"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

Tests are hermetic and run on the CPU unless JAX_PLATFORMS says
otherwise. Tests marked `gpu` need the card: they skip here and run there
with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session", autouse=True)
def native_library():
    """Build native/ (the C++ host tail; not committed) once, before any
    test: the file lock keeps parallel test workers from building the
    same library at the same time."""
    import fcntl
    import subprocess
    native = os.path.join(ROOT, "native")
    with open(os.path.join(native, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", native], check=True,
                       capture_output=True)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time, not
    at import, so every test worker collects the same tests)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on the "
                    "card)")
