"""PLS header (MODCOD) detection — batched min-Hamming over all 128 codes.

Replaces the reference's S2PLHDRDemod
(/root/reference/src/demod/dvbs2/dvbs2_plhdr_demod.cpp:33-79): instead of
an independent pi/2-BPSK PLL + hard compare loop, we soft-correlate the
64 phase-corrected PLS symbols against all 128 codeword symbol patterns
in one [F,64]x[64,128] matmul and pick the max — equivalent to
min-Hamming on hard bits (the reference masks to bits 59..0; codewords
differ in >=32 of those bits so the soft correlation dominates equally).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import plheader


@functools.lru_cache()
def _pls_sym_matrix() -> np.ndarray:
    """[128, 64] complex64 — pi/2-BPSK symbols of each PLS codeword."""
    return plheader.pls_symbols()


def detect_pls(headers: jax.Array) -> tuple[jax.Array, jax.Array]:
    """headers: [F, 90] phase-corrected header symbols.

    Returns (pls_index [F] int32, confidence [F] float32 in [0,1]).
    pls_index = MODCOD<<2 | short<<1 | pilots.
    """
    pls = headers[:, 26:90]                           # [F, 64]
    M = jnp.asarray(_pls_sym_matrix())                # [128, 64]
    # HIGHEST: the argmax and the confidence threshold decide on these
    # sums (TF32 would round them to ~3 decimal digits)
    corr = jnp.real(jnp.matmul(pls, jnp.conj(M).T,
                               precision=jax.lax.Precision.HIGHEST))
    idx = jnp.argmax(corr, axis=1).astype(jnp.int32)
    conf = jnp.take_along_axis(corr, idx[:, None], axis=1)[:, 0] / 64.0
    return idx, conf


def split_pls(pls_index):
    """pls_index -> (modcod, shortframes, pilots) (plhdr_demod.cpp:62-64)."""
    return (pls_index >> 2) & 0x1F, (pls_index >> 1) & 1, pls_index & 1
