"""Batched Viterbi decoder for the DVB-S K=7 rate-1/2 code (JAX).

Device replacement for the reference's volk `spiral` ACS kernel +
chainback (/root/reference/src/demod/dvbs/viterbi/cc_decoder.cpp:56-92,
295-302): instead of streaming 8192-bit blocks with start-state chaining,
the stream is cut into overlapping segments decoded in parallel — the
64-state add-compare-select runs as a lax.scan over time with all
segments on the batch axis, and the wings (>= 15 constraint lengths)
absorb the unknown boundary states, so the core bits equal a streaming
decode.

Soft convention: float LLRs, positive = bit 0, 0 = erasure (depunctured).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import dvbs_fec

N_STATES = 64


@functools.lru_cache()
def _trellis():
    """Precompute predecessor/branch tables.

    prev[ns, j]: predecessor state (j = dropped LSB of the predecessor),
    sign[ns, j, 2]: expected (X, Y) as +-1 (+1 = bit 0) for that branch.
    """
    prev = np.zeros((N_STATES, 2), np.int32)
    sign = np.zeros((N_STATES, 2, 2), np.float32)
    for ns in range(N_STATES):
        b = ns >> 5
        base = (ns & 0x1F) << 1
        for j in range(2):
            s = base | j
            v = (b << 6) | s
            x = bin(v & dvbs_fec.G1).count("1") & 1
            y = bin(v & dvbs_fec.G2).count("1") & 1
            prev[ns, j] = s
            sign[ns, j, 0] = 1.0 - 2.0 * x
            sign[ns, j, 1] = 1.0 - 2.0 * y
    return prev, sign


@functools.lru_cache()
def _trellis_k(k: int):
    """Radix-2^k trellis tables (k trellis steps fused per scan step).

    With the register shifting right (new bit enters at the MSB), the
    state after k steps is ns = (b_k..b_1 in bits 5..6-k) | (s_prev >> k),
    so for fixed dropped-LSBs j the predecessor is a pure index
    remapping prev = ((ns & low_mask) << k) | j — candidate expansion
    is a reshape+broadcast with NO gather (see decode_segments).

    Returns (sign [64, 2^k, 2k] expected +-1 outputs for the fused
    branch, earliest (X, Y) pair first; bits_hi [2^k, k] the k input
    bits as a function of ns's top k bits, earliest first).
    """
    assert 1 <= k <= 6
    R = 1 << k
    sign = np.zeros((N_STATES, R, 2 * k), np.float32)
    bits_hi = np.zeros((R, k), np.float32)
    low_mask = (1 << (6 - k)) - 1
    for hi in range(R):
        # b_i sits at bit (6 - k + i - 1) of ns for i = 1..k
        bits_hi[hi] = [(hi >> i) & 1 for i in range(k)]
    for ns in range(N_STATES):
        bs = [(ns >> (6 - k + i)) & 1 for i in range(k)]   # b_1..b_k
        for j in range(R):
            s = ((ns & low_mask) << k) | j                 # predecessor
            for i in range(k):
                v = (bs[i] << 6) | s
                x = bin(v & dvbs_fec.G1).count("1") & 1
                y = bin(v & dvbs_fec.G2).count("1") & 1
                sign[ns, j, 2 * i] = 1.0 - 2.0 * x
                sign[ns, j, 2 * i + 1] = 1.0 - 2.0 * y
                s = (bs[i] << 5) | (s >> 1)
            assert s == ns
    return sign, bits_hi


@functools.partial(jax.jit, static_argnames=("k",))
def decode_segments(llrs: jax.Array, k: int = 4) -> jax.Array:
    """llrs [B, T, 2] float (positive = bit 0) -> bits [B, T] uint8.

    Unknown start state (all path metrics equal), traceback from the
    best end state.  Radix-2^k ACS: k trellis steps fuse into one scan
    step, cutting the sequential depth k-fold (the per-step work grows
    2^k-fold but stays tiny next to the scan-step latency — the
    reference's SSE kernel is one-step-at-a-time, cc_decoder.cpp:56-92).
    Everything is gather-free: candidate expansion is a reshape +
    broadcast (predecessor = ((ns & low) << k) | j), and traceback
    carries the state as a one-hot vector updated with masked reductions
    (one-hot selects instead of gathers).

    T is zero-padded (erasures) to a multiple of k: appended zero-LLR
    steps leave every path metric unchanged, and their ACS decisions
    follow the best predecessor, so traceback through them lands exactly
    on the best time-T state.
    """
    sign_np, bits_hi_np = _trellis_k(k)
    R = 1 << k
    LO = N_STATES >> k                    # 2^(6-k) low-state values
    sign = jnp.asarray(sign_np.reshape(N_STATES * R, 2 * k).T)  # [2k, 64R]
    bits_hi = jnp.asarray(bits_hi_np)     # [R, k]
    B, T, _ = llrs.shape
    Tk = -(-T // k) * k
    if Tk != T:
        llrs = jnp.pad(llrs, ((0, 0), (0, Tk - T), (0, 0)))
    nsteps = Tk // k
    # [B, nsteps, 2k] -> scan-major [nsteps, B, 2k]
    r_sup = jnp.swapaxes(llrs.reshape(B, nsteps, 2 * k), 0, 1)

    def acs(pm, r):
        # r: [B, 2k]; pm: [B, 64] (layout ns = lo * 2^k + j-of-next...
        # plain integer order). bm via one small matmul (HIGHEST: the
        # compare-selects decide on these sums; no TF32 rounding).
        bm = jax.lax.dot_general(
            r, sign, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)        # [B, 64R]
        bm = bm.reshape(B, R, LO, R)                    # [B, hi, lo, j]
        # cand[b, (hi, lo), j] = pm[b, lo * 2^k + j] — reshape+broadcast
        cand = pm.reshape(B, 1, LO, R) + bm
        dec = jnp.argmax(cand, axis=3)                  # [B, hi, lo]
        newpm = jnp.max(cand, axis=3).reshape(B, N_STATES)
        newpm = newpm - jnp.max(newpm, axis=1, keepdims=True)
        return newpm, dec.reshape(B, N_STATES).astype(jnp.uint8)

    pm0 = jnp.zeros((B, N_STATES), jnp.float32) + 0.0 * llrs[:, 0, 0:1]
    pm, decs = jax.lax.scan(acs, pm0, r_sup)            # decs [nsteps, B, 64]

    end = jnp.argmax(pm, axis=1).astype(jnp.int32)      # [B]
    oh0 = (jnp.arange(N_STATES)[None, :] == end[:, None]).astype(llrs.real.dtype)

    jr = jnp.arange(R, dtype=jnp.uint8)

    def trace(oh, dec_t):
        # oh: one-hot state [B, 64] = [B, hi, lo]; dec_t: [B, 64] uint8
        ohr = oh.reshape(B, R, LO)
        # k input bits of this super-step live in the state's hi bits
        # exact at any precision: one-hot times 0/1 bits
        bits = jnp.dot(jnp.sum(ohr, axis=2), bits_hi,
                       precision=jax.lax.Precision.DEFAULT)  # [B, k]
        dsel = (dec_t.reshape(B, R, LO, 1) == jr).astype(oh.dtype)
        # pred one-hot over (lo, j): sum_hi oh[b,hi,lo] * [dec==j]
        poh = jnp.sum(ohr[:, :, :, None] * dsel, axis=1)  # [B, LO, R]
        return poh.reshape(B, N_STATES), bits

    _, bits_sup = jax.lax.scan(trace, oh0, decs, reverse=True)
    # bits_sup [nsteps, B, k] aligned with inputs -> [B, T]
    bits = jnp.swapaxes(bits_sup, 0, 1).reshape(B, Tk)[:, :T]
    return (bits > 0.5).astype(jnp.uint8)


def segment_stream(llrs: np.ndarray, core: int = 2048, wing: int = 96):
    """Cut [n, 2] stream into overlapping segments [B, core+2*wing, 2].

    Returns (segments, n_core_bits). Stream edges are zero-padded
    (erasures).
    """
    n = len(llrs)
    B = max(1, -(-n // core))
    padded = np.zeros((B * core + 2 * wing, 2), llrs.dtype)
    padded[wing:wing + n] = llrs[:B * core]
    segs = np.stack([padded[i * core:i * core + core + 2 * wing]
                     for i in range(B)])
    return segs, n


def decode_stream(llrs: np.ndarray, core: int = 2048, wing: int = 96
                  ) -> np.ndarray:
    """Convenience host path: [n, 2] float -> [n] uint8 decoded bits."""
    segs, n = segment_stream(llrs, core, wing)
    bits = np.asarray(decode_segments(jnp.asarray(segs, jnp.float32)))
    return bits[:, wing:wing + core].reshape(-1)[:n]
