"""Which implementation each stage runs on each platform, in one place.

The choice is keyed on the platform a program is LOWERED for (through
lax.platform_dependent), not on the process's default backend, so a
program built for the CPU in a GPU process (or the reverse) gets the
route of its own target. A kernel that fails to compile on its platform
is an error: no route falls back to another, and Pallas interpret mode
is reached only through an explicit `interpret=True` (tests).
"""
from __future__ import annotations

import jax

# stage -> platform -> route
ROUTES = {
    "resample": {"cpu": "xla", "gpu": "xla"},
    "viterbi": {"cpu": "xla", "gpu": "xla"},
    "ldpc": {"cpu": "xla", "gpu": "triton"},
}

# JAX lowering platform names -> the device platform names used above
_LOWERING = {"cpu": "cpu", "cuda": "gpu"}


def resolve(stage: str, platform: str) -> str:
    """Route of `stage` on `platform` ("cpu" or "gpu"); unknown stages
    and platforms are errors, not defaults."""
    try:
        return ROUTES[stage][platform]
    except KeyError:
        raise ValueError(f"no route for stage {stage!r} on platform "
                         f"{platform!r}") from None


def ldpc_decode(llrs: jax.Array, table: str, n_iters: int,
                interpret: bool = False):
    """LDPC-decode float LLRs [B, N] on the route of the platform the
    program is lowered for. Returns (hard [B, N] uint8, n_bad [B] int32,
    trials [B] int32).

    interpret=True runs the GPU kernel in Pallas interpret mode on any
    platform (CPU tests of the kernel route)."""
    from . import ldpc_pallas, ldpc_qc

    impls = {
        "xla": lambda x: ldpc_qc.decode_qc(x, table, n_iters=n_iters),
        "triton": lambda x: ldpc_pallas.decode_qc_pallas(
            ldpc_pallas.quantize_llrs(x), table, n_iters=n_iters,
            interpret=interpret),
    }
    with jax.named_scope("ldpc"):
        if interpret:
            return impls["triton"](llrs)
        return jax.lax.platform_dependent(
            llrs, **{low: impls[resolve("ldpc", plat)]
                     for low, plat in _LOWERING.items()})
