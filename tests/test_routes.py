"""Route choice (ops/routes.py), the compile-cache location, the CPU
refusal of chip_smoke.py, and the XLA LDPC route over a whole block."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvbs_tpu.ops import ldpc_qc, routes
from dvbs_tpu.spec import ldpc_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("stage,platform,route", [
    ("ldpc", "gpu", "triton"),
    ("ldpc", "cpu", "xla"),
    ("viterbi", "gpu", "xla"),
    ("viterbi", "cpu", "xla"),
    ("resample", "gpu", "xla"),
    ("resample", "cpu", "xla"),
])
def test_resolver_choice(stage, platform, route):
    assert routes.resolve(stage, platform) == route


@pytest.mark.parametrize("stage,platform", [
    ("ldpc", "tpu"), ("ldpc", "rocm"), ("fft", "gpu")])
def test_resolver_refuses_unknown(stage, platform):
    with pytest.raises(ValueError):
        routes.resolve(stage, platform)


def _ldpc_program(interpret=False):
    n = ldpc_spec.get_code("C4").N
    return jax.jit(lambda x: routes.ldpc_decode(
        x, "C4", 4, interpret=interpret)).trace(
            jnp.zeros((3, n), jnp.float32))


@pytest.mark.parametrize("platform,kernel", [("cuda", True),
                                             ("cpu", False)])
def test_ldpc_route_follows_lowering_platform(platform, kernel):
    """The LDPC route is chosen for the platform the program is lowered
    for, not the process's default backend: lowering the same traced
    program for CUDA from this CPU process carries the Triton kernel,
    lowering it for the CPU does not."""
    text = _ldpc_program().lower(lowering_platforms=(platform,)).as_text()
    assert ("triton" in text) == kernel


def test_ldpc_interpret_runs_the_kernel_on_cpu():
    """interpret=True is the only way to the kernel on the CPU: the
    result carries the kernel's int8 numerics (its own trial counts),
    lowered without any Triton call."""
    text = _ldpc_program(interpret=True).lower(
        lowering_platforms=("cpu",)).as_text()
    assert "triton" not in text
    code = ldpc_spec.get_code("C4")
    rng = np.random.default_rng(3)
    cw = code.encode(rng.integers(0, 2, (2, code.K)).astype(np.uint8))
    llr = (1.0 - 2.0 * cw) * 6.0 + rng.normal(0, 1.5, cw.shape)
    hard, bad, trials = routes.ldpc_decode(
        jnp.asarray(llr, jnp.float32), "C4", 8, interpret=True)
    np.testing.assert_array_equal(np.asarray(hard), cw)
    assert (np.asarray(bad) == 0).all()


def test_decode_qc_all_lanes_equals_chunked():
    """decode_qc over every frame of a block in one call (the CPU route
    now) equals the old 24-lane chunked decode bit for bit: frames are
    independent columns of the same arithmetic."""
    code = ldpc_spec.get_code("C4")
    rng = np.random.default_rng(4)
    B = 30
    cw = code.encode(rng.integers(0, 2, (B, code.K)).astype(np.uint8))
    llr = ((1.0 - 2.0 * cw) * 2.5 +
           rng.normal(0, 1.2, cw.shape)).astype(np.float32)
    whole = ldpc_qc.decode_qc(jnp.asarray(llr), "C4", n_iters=6)
    parts = [ldpc_qc.decode_qc(jnp.asarray(llr[lo:lo + 24]), "C4",
                               n_iters=6) for lo in range(0, B, 24)]
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(whole[i]),
            np.concatenate([np.asarray(p[i]) for p in parts]))


def _run(code, env_extra, env_drop=()):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


CACHE_PROBE = ("from dvbs_tpu import compile_cache; import jax; "
               "print(compile_cache.enable()); "
               "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_default_is_checkout_dir():
    p = _run(CACHE_PROBE, {"JAX_PLATFORMS": "cpu"},
             env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert p.returncode == 0, p.stderr
    used, configured = p.stdout.split()
    assert used == configured == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_env_var_wins(tmp_path):
    d = str(tmp_path / "jc")
    p = _run(CACHE_PROBE, {"JAX_PLATFORMS": "cpu",
                           "JAX_COMPILATION_CACHE_DIR": d})
    assert p.returncode == 0, p.stderr
    used, configured = p.stdout.split()
    assert used == configured == d


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits non-zero before compiling
    anything and prints no result line."""
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr
