"""Soft demapper: exact LLRs, vectorized over symbols and frames (JAX).

Reproduces the reference's demod_soft_calc semantics
(/root/reference/src/demod/common/dsp/demod/constellation.cpp:205-270):
per-bit LLR = log-ratio of summed exp(-distance/npwr) over constellation
subsets, scaled by const_sca=50 and clamped to int8 range by repeated
halving.  The reference's internal per-constellation scale factors
(const_amp x const_prescale applied to the sample vs its point tables)
reduce, with our unit-power point tables, to a (sample_scale, point_scale)
pair per constellation — derived in ops/demap.py history: QPSK (3,2),
8PSK (1,1), 16APSK (53,50), 32APSK (54,50).

Unlike the reference we evaluate the formula directly on device instead of a
256x256 LUT — the vectorized exact computation is cheaper than a gather.
Output is standard bit order (y0 first), positive LLR = bit 0, matching
the LDPC decoder's convention.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import constellations, modcod

# (sample_scale, point_scale, llr_scale): reference
# const_amp*const_prescale applied to the sample, the point table's own
# magnitude relative to unit power, and const_sca. NOTE the reference
# overrides const_sca to 1 for the APSK types (constellation.cpp:60,95)
# — their distances are already in a ~50x domain (const_amp=100, radii
# halved) so the log-ratios come out at int8 scale without the x50.
# Cross-checked against the compiled reference demapper per
# constellation in tests/test_interop.py.
_SCALES = {
    modcod.QPSK: (3.0, 2.0, 50.0),
    modcod.PSK8: (1.0, 1.0, 50.0),
    modcod.APSK16: (53.0, 50.0, 1.0),
    modcod.APSK32: (54.0, 50.0, 1.0),
}


@functools.lru_cache()
def _tables(kind: str, g1: float | None, g2: float | None):
    pts = constellations.points(kind, g1, g2).astype(np.complex64)
    m = modcod.MOD_BITS[kind]
    S = len(pts)
    # mask[k, s] = True when standard bit y_k of symbol s is 0
    mask0 = np.zeros((m, S), bool)
    for s in range(S):
        for k in range(m):
            mask0[k, s] = ((s >> (m - 1 - k)) & 1) == 0
    return pts, mask0


def _clamp_halving(x):
    """Reference int8 clamp: halve until |x| <= 127 (constellation.cpp:263-270)."""
    mag = jnp.abs(x)
    k = jnp.ceil(jnp.log2(jnp.maximum(mag / 127.0, 1.0)))
    return x * jnp.exp2(-k)


@functools.partial(jax.jit, static_argnames=("kind", "g1", "g2", "npwr"))
def soft_demap(syms: jax.Array, kind: str, g1: float | None = None,
               g2: float | None = None, npwr: float = 1.0) -> jax.Array:
    """syms [...] complex -> LLRs [..., m] float32 in int8 range.

    Positive = bit 0. Uses exp(-distance/npwr) with Euclidean distance
    (not squared), const_sca=50, and halving clamp — the reference's
    formula evaluated exactly.
    """
    pts, mask0 = _tables(kind, g1, g2)
    ss, ps, sca = _SCALES[kind]
    x = syms[..., None] * ss                              # [..., 1]
    d = jnp.abs(x - jnp.asarray(pts) * ps)                # [..., S]
    neg = -d / npwr
    m0 = jnp.asarray(mask0)                               # [m, S]
    # logsumexp over each subset
    def lse(mask):
        z = jnp.where(mask, neg[..., None, :], -jnp.inf)  # [..., m, S]
        zmax = jnp.max(z, axis=-1, keepdims=True)
        return (jnp.log(jnp.sum(jnp.exp(z - zmax), axis=-1)) +
                zmax[..., 0])
    llr = (lse(m0) - lse(~m0)) * sca                      # [..., m]
    return _clamp_halving(llr).astype(jnp.float32)


def hard_decision(llrs: jax.Array) -> jax.Array:
    """LLR -> bit (positive = 0)."""
    return (llrs < 0).astype(jnp.uint8)
