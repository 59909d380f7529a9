"""Decision-directed LMS equalizer (block feed-forward formulation).

Parity component for the reference's equalizer::LMS
(/root/reference/src/demod/common/dsp/demod/lms.{h,cpp}: 65-tap complex
decision-directed LMS with a QPSK slicer) — which the reference
instantiates but leaves disabled (module_dvbs2_demod.cpp:50,84,242).
Here it is enabled on demand via DVBS2Receiver(equalize=True), which
inserts it after timing recovery, before PL sync (models/dvbs2.py).

Block formulation: instead of the per-sample stochastic update, the block
is split into chunks; each chunk solves a small regularized
least-squares fit of the taps to the slicer decisions (block LMS /
Wiener step), carried across chunks by averaging with the previous taps
— feed-forward, batched, and convergent at the same operating points.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _qpsk_slice(z):
    s = np.float32(1 / np.sqrt(2))
    return (jnp.where(jnp.real(z) > 0, s, -s) +
            1j * jnp.where(jnp.imag(z) > 0, s, -s)).astype(z.dtype)


@functools.partial(jax.jit, static_argnames=("n_taps", "n_chunks"))
def lms_equalize(z: jax.Array, n_taps: int = 17, n_chunks: int = 8,
                 ridge: float = 1e-2) -> jax.Array:
    """Equalize a symbol stream with a block decision-directed LS filter.

    z: [n] complex symbols (timing- and carrier-recovered).
    Returns equalized [n] complex64.
    """
    n = z.shape[-1]
    chunk = n // n_chunks
    half = n_taps // 2
    zp = jnp.pad(z, (half, half))
    # data matrix rows: window around each symbol
    def windows(lo, m):
        cols = [zp[lo + j: lo + j + m] for j in range(n_taps)]
        return jnp.stack(cols, axis=1)                # [m, n_taps]
    taps = jnp.zeros(n_taps, jnp.complex64).at[half].set(1.0)
    out = []
    for c in range(n_chunks):
        lo = c * chunk
        m = chunk if c < n_chunks - 1 else n - lo
        A = windows(lo, m)
        y = A @ taps
        d = _qpsk_slice(y)
        # regularized normal equations on this chunk
        G = jnp.conj(A.T) @ A / m + ridge * jnp.eye(n_taps)
        r = jnp.conj(A.T) @ d / m
        new_taps = jnp.linalg.solve(G, r)
        taps = 0.5 * taps + 0.5 * new_taps            # smooth adaptation
        out.append(A @ taps)
    return jnp.concatenate(out).astype(jnp.complex64)
