"""Quasi-cyclic layered LDPC decoder — Pallas kernel for Hopper (Triton).

The same int8 offset-min-sum layered schedule over the same QC structure
as the XLA decoder (ops/ldpc_qc.py, qc_tables), written as ONE program
per frame:

- the grid is the frame axis: a program decodes its frame alone, so any
  frame count works (no padding) and the 128-frame bank block spreads
  over the card's streaming multiprocessors one frame each;
- the frame's posterior ([(G+q)*360] int8) and check-to-variable
  messages ([q, Dmax, 360] int8) live in device-memory outputs that the
  program owns (~290 KB a frame at rate 1/2, so a 128-frame block stays
  inside the 50 MB L2 cache);
- every sweep runs inside the program, and the program stops at the
  first sweep whose in-kernel online syndrome is zero (per-frame early
  exit, the reference's `while bad() && trials--`,
  layered_decoder.hh:121-133);
- the program reads its own (group, shift, flags) schedule table;
- the cyclic shift of a 360-row group is a masked gather of a 512-wide
  vector (row m reads row (m - s) mod 360), and the write-back scatters
  to the same addresses.

Within a program the lanes of one layer exchange data through device
memory, so the layer is fenced with block barriers: after the reads
(pass 1), after each wave of writes (a group that appears twice in a
layer is written again in a later wave, after re-reading the first
write), and at the end of the layer.

Arithmetic is int32 with saturation to int8 on store — the numeric family
of the reference's int8 SIMD decoder (dvbs2/codings/xdsopl-ldpc-pabr/,
generic.hh) and bit-exact with the numpy model in
tests/test_ldpc_pallas.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .ldpc_qc import qc_tables, LANES

VEC = 512            # block width: the 360 rows of a group, rounded up
NUM_WARPS = 16       # one thread per row of the 512-wide block
MSG_CLIP = 31        # message magnitude cap (posterior headroom, see kernel)

# schedule-table entry: group | shift << 9 | flags << 18 | wave << 20
_S_SHIFT, _F_SHIFT, _W_SHIFT = 9, 18, 20
F_VALID = 1
F_MASK0 = 2          # wrap entry of layer 0: column 0 carries no edge


def quantize_llrs(llr: jax.Array) -> jax.Array:
    """Float LLRs [B, N] -> int8 at the kernel's operating scale
    (rms ~ 8: strong bits ~ +-25, leaving ~4 message amplitudes of
    posterior headroom below the int8 clip). The rms is PER FRAME so
    a strong carrier in a mixed-SNR bank cannot crush the weak
    carriers' quantization."""
    rms = jnp.sqrt(jnp.mean(llr.astype(jnp.float32) ** 2,
                            axis=1, keepdims=True)) + 1e-20
    return jnp.clip(jnp.round(llr * (8.0 / rms)), -127, 127
                    ).astype(jnp.int8)


@functools.lru_cache()
def kernel_tables(table: str):
    """Packed schedule table int32 [q, Dmax] + layout constants.

    Layer r's entries are its info groups (group, shift), then the
    current parity group (G+r, 0) and the previous one (G+r-1, 0) — for
    r = 0 the wrap edge (G+q-1, 1) with row 0 masked. `wave` counts
    earlier entries of the same group in the layer: wave w is written
    after wave w-1, re-reading the group, so repeated groups accumulate
    their deltas in schedule order."""
    t = qc_tables(table)
    G, q = t["G"], t["q"]
    rows = []
    for r in range(q):
        ents = [(g, s, F_VALID) for (g, s) in t["layers"][r]]
        ents.append((G + r, 0, F_VALID))                      # parity a=r
        if r == 0:
            ents.append((G + q - 1, 1, F_VALID | F_MASK0))    # wrap edge
        else:
            ents.append((G + r - 1, 0, F_VALID))
        rows.append(ents)
    Dmax = max(len(e) for e in rows)
    tab = np.zeros((q, Dmax), np.int32)
    waves = 1
    for r, ents in enumerate(rows):
        seen: dict[int, int] = {}
        for e, (g, s, f) in enumerate(ents):
            w = seen.get(g, 0)
            seen[g] = w + 1
            waves = max(waves, w + 1)
            tab[r, e] = g | (s << _S_SHIFT) | (f << _F_SHIFT) | (w << _W_SHIFT)
    return dict(G=G, q=q, Dmax=Dmax, waves=waves, tab=tab,
                N=t["N"], K=t["K"])


def llr_to_frames(llr: jax.Array, G: int, q: int) -> jax.Array:
    """[B, N] codeword order -> [B, (G+q)*360] posterior layout: info
    bit i stays at i, parity bit a = r + q*c moves to (G+r)*360 + c."""
    B = llr.shape[0]
    K = G * LANES
    par = jnp.transpose(llr[:, K:].reshape(B, LANES, q), (0, 2, 1))
    return jnp.concatenate([llr[:, :K], par.reshape(B, q * LANES)], axis=1)


def frames_to_hard(post: jax.Array, G: int, q: int) -> jax.Array:
    """Inverse of llr_to_frames on the sign: [B, (G+q)*360] -> hard
    bits [B, N] uint8."""
    B = post.shape[0]
    K = G * LANES
    par = jnp.transpose(post[:, K:].reshape(B, q, LANES), (0, 2, 1))
    bits = jnp.concatenate([post[:, :K], par.reshape(B, q * LANES)], axis=1)
    return (bits < 0).astype(jnp.uint8)


def _kernel(tab_ref, llr_ref, post_ref, msg_ref, res_ref, *, q, Dmax,
            waves, n_post, n_msg, n_iters, beta, early_exit, interpret):
    m = jax.lax.broadcasted_iota(jnp.int32, (VEC,), 0)
    row_ok = m < LANES
    row0 = m == 0
    big = jnp.int32(16384)

    def barrier():
        # interpret mode runs the lanes in lockstep; on the card the
        # lanes of a layer trade rows through device memory
        if not interpret:
            plt.debug_barrier()

    def copy_in(c, carry):
        idx = c * VEC + m
        ok = idx < n_post
        idx = jnp.where(ok, idx, n_post + m)
        plt.store(post_ref.at[0, idx],
                  plt.load(llr_ref.at[0, idx], mask=ok, other=0), mask=ok)
        return carry

    jax.lax.fori_loop(0, -(-n_post // VEC), copy_in, 0)
    barrier()

    def layer(r, bad, it):
        first_sweep = it == 0
        ents = []
        # ---- pass 1: variable-to-check values, running two-min, and the
        # parity of the posterior signs over the check row (the online
        # per-layer syndrome: later layers see posteriors already
        # updated this sweep)
        m1 = m2 = am = par = pxor = None
        for e in range(Dmax):
            word = tab_ref[r, e]
            g = word & ((1 << _S_SHIFT) - 1)
            s = (word >> _S_SHIFT) & ((1 << (_F_SHIFT - _S_SHIFT)) - 1)
            fl = (word >> _F_SHIFT) & 3
            wave = word >> _W_SHIFT
            valid = (fl & F_VALID) != 0
            masked = ((fl & F_MASK0) != 0) & row0
            src = m - s
            ok = row_ok & valid
            # masked lanes address a pad row of their own: interpret mode
            # stores them (unchanged), and they must not alias a live row
            idx = jnp.where(ok, g * LANES + jnp.where(src >= 0, src,
                                                      src + LANES),
                            n_post + m)
            rolled = plt.load(post_ref.at[0, idx], mask=ok,
                              other=0).astype(jnp.int32)
            midx = jnp.where(ok, (r * Dmax + e) * LANES + m, n_msg + m)
            old = plt.load(msg_ref.at[0, midx], mask=ok & ~first_sweep,
                           other=0).astype(jnp.int32)
            v = rolled - old
            kill = masked | ~valid
            a = jnp.where(kill, big, jnp.abs(v))
            neg = jnp.where(kill, 0, (v < 0).astype(jnp.int32))
            pneg = jnp.where(kill, 0, (rolled < 0).astype(jnp.int32))
            if e == 0:
                m1, m2, am = a, big + 0 * a, 0 * a
                par, pxor = neg, pneg
            else:
                isnew = a < m1
                m2 = jnp.where(isnew, m1, jnp.minimum(m2, a))
                m1 = jnp.where(isnew, a, m1)
                am = jnp.where(isnew, e, am)
                par = par ^ neg
                pxor = pxor ^ pneg
            ents.append((idx, ok, wave, kill, midx, rolled, old, neg))
        bad = bad + jnp.sum(jnp.where(row_ok, pxor, 0))
        barrier()

        # ---- pass 2: new messages and the saturating posterior update
        deltas = []
        for e, (idx, ok, wave, kill, midx, rolled, old, neg) in \
                enumerate(ents):
            excl = jnp.where(am == e, m2, m1)
            # message magnitudes cap at MSG_CLIP (not 127): the int8
            # posterior must hold llr + the sum of ~3..7 messages without
            # saturating, or the delta-form update clips inconsistently
            # and the decode hits an error floor (tests/test_ldpc_pallas)
            mag = jnp.clip(excl - beta, 0, MSG_CLIP)
            # sign of the product of the OTHER inputs
            news = jnp.where((par ^ neg) > 0, -mag, mag)
            news = jnp.where(kill, 0, news)
            # self-corrected min-sum (the reference's SelfCorrectedUpdate,
            # xdsopl-ldpc-pabr/algorithms.hh): a message whose sign
            # flipped since the last sweep is erased
            news = jnp.where((old != 0) & ((old ^ news) < 0), 0, news)
            delta = news - old
            plt.store(msg_ref.at[0, midx], news.astype(jnp.int8), mask=ok)
            plt.store(post_ref.at[0, idx],
                      jnp.clip(rolled + delta, -127, 127).astype(jnp.int8),
                      mask=ok & (wave == 0))
            deltas.append(delta)
        for w in range(1, waves):
            # repeated groups: re-read what the earlier wave wrote
            barrier()
            for (idx, ok, wave, *_), delta in zip(ents, deltas):
                wok = ok & (wave == w)
                cur = plt.load(post_ref.at[0, idx], mask=wok,
                               other=0).astype(jnp.int32)
                plt.store(post_ref.at[0, idx],
                          jnp.clip(cur + delta, -127, 127).astype(jnp.int8),
                          mask=wok)
        barrier()
        return bad

    def sweep_cond(carry):
        it, trials, bad = carry
        go = it < n_iters
        if early_exit:
            go = go & (bad != 0)
        return go

    def sweep(carry):
        it, trials, _ = carry
        bad = jax.lax.fori_loop(0, q, lambda r, b: layer(r, b, it),
                                jnp.int32(0))
        trials = jnp.where((trials == n_iters) & (bad == 0), it + 1, trials)
        return it + 1, trials, bad

    # bad = 1 means "unknown" until the first sweep
    _, trials, bad = jax.lax.while_loop(
        sweep_cond, sweep, (jnp.int32(0), jnp.int32(n_iters), jnp.int32(1)))
    two = jax.lax.broadcasted_iota(jnp.int32, (2,), 0)
    res_ref[0, :] = jnp.where(two == 0, bad, trials)


@functools.partial(jax.jit, static_argnames=("table", "n_iters", "beta",
                                             "interpret", "early_exit"))
def decode_qc_pallas(llr_i8: jax.Array, table: str, n_iters: int = 16,
                     beta: int = 1, interpret: bool = False,
                     early_exit: bool = True):
    """Layered OMS decode of any number of frames, one program each.

    llr_i8: [B, N] int8 LLRs (positive = bit 0; quantize_llrs scale).
    Returns (hard [B, N] uint8, n_bad_checks [B] int32 — the online
    syndrome count of the frame's last sweep, trials [B] int32 — the
    sweep at which that count first read zero, n_iters if never,
    mirroring the reference's trials-used-or-max metric,
    bbframe_ldpc.cpp:123-139).

    early_exit=True stops each frame at its first clean sweep;
    early_exit=False runs all n_iters sweeps (bit-exact comparisons).
    interpret=True runs the kernel in Pallas interpret mode (CPU tests).
    """
    kt = kernel_tables(table)
    G, q, Dmax = kt["G"], kt["q"], kt["Dmax"]
    B, N = llr_i8.shape
    assert N == kt["N"], (N, kt["N"])
    n_msg = q * Dmax * LANES
    # each frame's rows end in a pad row of VEC that only masked lanes
    # address (see _kernel)
    frames = jnp.pad(llr_to_frames(llr_i8, G, q), ((0, 0), (0, VEC)))
    # under shard_map the outputs vary over the same mesh axes as the input
    vma = jax.typeof(frames).vma
    kern = functools.partial(
        _kernel, q=q, Dmax=Dmax, waves=kt["waves"], n_post=N, n_msg=n_msg,
        n_iters=n_iters, beta=beta, early_exit=early_exit,
        interpret=interpret)
    post, _, res = pl.pallas_call(
        kern,
        grid=(B,),
        in_specs=[pl.BlockSpec((q, Dmax), lambda i: (0, 0)),
                  pl.BlockSpec((1, N + VEC), lambda i: (i, 0))],
        out_specs=[pl.BlockSpec((1, N + VEC), lambda i: (i, 0)),
                   pl.BlockSpec((1, n_msg + VEC), lambda i: (i, 0)),
                   pl.BlockSpec((1, 2), lambda i: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((B, N + VEC), jnp.int8, vma=vma),
                   jax.ShapeDtypeStruct((B, n_msg + VEC), jnp.int8, vma=vma),
                   jax.ShapeDtypeStruct((B, 2), jnp.int32, vma=vma)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="ldpc_layered_oms",
    )(jnp.asarray(kt["tab"]), frames)
    return frames_to_hard(post[:, :N], G, q), res[:, 0], res[:, 1]
