"""BCH syndrome computation on device as a GF(2) matmul.

The reference computes syndromes bit-serially per frame over GF(2^16)
(/root/reference/src/demod/dvbs2/codings/bch/bose_chaudhuri_hocquenghem_decoder.hh:41-71).
On device the whole syndrome vector is one matmul: S_j = c(alpha^j) is
GF(2)-linear in the codeword bits, so with M[i, (j,b)] = bit b of
alpha^(j*(nbch-1-i)), the packed syndrome bits are (bits @ M) mod 2 —
an [F, nbch] x [nbch, 2t*m] 0/1 matmul.  A frame is
clean iff its syndrome row is all zero; only dirty frames go to the host
Berlekamp-Massey repair path.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import bch_spec, modcod


@functools.lru_cache()
def syndrome_matrix(framesize: str, rate: str) -> np.ndarray:
    """[nbch, 2t*m] uint8 GF(2) syndrome matrix."""
    kbch, nbch, t = modcod.BCH_PARAMS[(framesize, rate)]
    gf = bch_spec.field_for(framesize)
    m = gf.m
    powers = (nbch - 1 - np.arange(nbch)).astype(np.int64)
    cols = []
    for j in range(1, 2 * t + 1):
        vals = gf.alpha_pow(j * powers)          # [nbch]
        bits = ((vals[:, None] >> np.arange(m)[None, :]) & 1).astype(np.uint8)
        cols.append(bits)
    return np.concatenate(cols, axis=1)          # [nbch, 2t*m]


@functools.partial(jax.jit, static_argnames=("framesize", "rate"))
def syndrome_nonzero(code_bits: jax.Array, framesize: str, rate: str
                     ) -> jax.Array:
    """code_bits [F, nbch] (0/1) -> [F] bool: True when syndromes != 0."""
    M = jnp.asarray(syndrome_matrix(framesize, rate), jnp.float32)
    # exact at any precision (TF32 included): 0/1 operands, f32 sums of
    # at most nbch < 2^24 ones
    s = jnp.dot(code_bits.astype(jnp.float32), M,
                precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=jnp.float32)
    odd = jnp.mod(s, 2.0)
    return (odd > 0.5).any(axis=1)
