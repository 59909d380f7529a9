"""Quasi-cyclic layered LDPC decoder (pure XLA, roll-based).

The DVB-S2 IRA codes are quasi-cyclic under the m-major reordering: with
q = (N-K)/360, parity address a = r + q*c maps to layer r and column c,
and table entry x of info group g connects check (r=x mod q, c) to info
bit (g, (c - x//q) mod 360) — a cyclic shift of the group's 360-vector.
All graph access therefore becomes static-shift rolls of [360, B] tiles,
no gathers at all:

  posterior tiles:  POST [G+q, 360, B]  (info groups then parity layers)
  layer r checks:   entries e: roll(POST[g_e], s_e), plus parity tiles
                    POST[G+r] and POST[G+r-1] (r=0: roll(POST[G+q-1], 1)
                    with the (c=0) wrap edge masked out)

One layered sweep = python-static loop over layers/entries; iterations
= lax.scan. This is the CPU route of ops/routes.py; the GPU route is the
int8 per-frame kernel of ops/ldpc_pallas.py.

Offset-min-sum, same beta=2 scale as the flooding decoder (ops/ldpc.py),
but layered: roughly half the iterations for the same BER.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import ldpc_spec

LANES = 360


@functools.lru_cache()
def qc_tables(table: str):
    """Static QC structure.

    Returns dict with:
      G, q: info-group count, layer count
      layers: list over r of list of (group g, shift s) info entries
      perm:  [N] int32 — POST-layout flat index for codeword bit i
    """
    code = ldpc_spec.get_code(table)
    q = code.q
    G = code.K // LANES
    layers = [[] for _ in range(q)]
    for g in range(G):
        row = code.rows[g]
        for x in row[row >= 0]:
            r = int(x) % q
            s = int(x) // q
            layers[r].append((g, s))
    # flat POST layout: info bit (g, m) -> g*360 + m;
    # parity bit a (= r + q*c) -> (G + r)*360 + c
    perm = np.empty(code.N, np.int64)
    i = np.arange(code.K)
    perm[:code.K] = i
    a = np.arange(code.R)
    perm[code.K:] = (G + (a % q)) * LANES + (a // q)
    return dict(G=G, q=q, layers=layers, perm=perm.astype(np.int32),
                N=code.N, K=code.K)


def llr_to_post(llr: jax.Array, G: int, q: int) -> jax.Array:
    """[B, N] codeword order -> POST layout [G+q, 360, B], gather-free.

    The QC permutation is structured: info bit i -> (i//360, i%360)
    (a plain reshape) and parity bit a = r + q*c -> (G+r, c) (a [360, q]
    -> [q, 360] transpose), a reshape and a transpose instead of a
    64800-row `.at[perm].set` scatter.
    """
    B = llr.shape[0]
    K = G * LANES
    info = llr[:, :K].T.reshape(G, LANES, B)
    par = jnp.transpose(llr[:, K:].reshape(B, LANES, q), (2, 1, 0))
    return jnp.concatenate([info, par], axis=0)


def post_to_hard(post: jax.Array, G: int, q: int) -> jax.Array:
    """POST layout [G+q, 360, B] -> hard bits [B, N] (inverse of
    llr_to_post on the sign)."""
    B = post.shape[-1]
    info = (post[:G].reshape(G * LANES, B) < 0).astype(jnp.uint8).T
    par = (jnp.transpose(post[G:], (2, 1, 0)) < 0
           ).astype(jnp.uint8).reshape(B, q * LANES)
    return jnp.concatenate([info, par], axis=1)


def to_qc_layout(llr: np.ndarray, table: str) -> np.ndarray:
    """[B, N] -> [G+q, 360, B] (numpy helper)."""
    t = qc_tables(table)
    B = llr.shape[0]
    flat = np.empty(((t["G"] + t["q"]) * LANES, B), llr.dtype)
    flat[t["perm"]] = llr.T
    return flat.reshape(t["G"] + t["q"], LANES, B)


def from_qc_layout(post: np.ndarray, table: str) -> np.ndarray:
    """[G+q, 360, B] -> [B, N]."""
    t = qc_tables(table)
    flat = post.reshape(-1, post.shape[-1])
    return flat[t["perm"]].T


@functools.partial(jax.jit,
                   static_argnames=("table", "n_iters", "beta",
                                    "track_trials"))
def decode_qc(llr: jax.Array, table: str, n_iters: int = 16,
              beta: float = 2.0, track_trials: bool = True):
    """QC layered offset-min-sum decode in pure XLA (rolls, no gathers).

    Runs a fixed number of layered sweeps (no early exit); with
    track_trials the syndrome is
    evaluated after every sweep and the per-frame sweep count at which the
    checks first cleared is reported — the same per-frame trial count the
    reference's bad()-gated loop reports (layered_decoder.hh:121-133,
    GUI ldpc_trials main.cpp:466).

    llr: [B, N] float32, positive = bit 0.
    Returns (hard [B, N] uint8, n_bad_checks [B] int32,
             trials [B] int32 — sweeps to convergence, n_iters if never).
    """
    t = qc_tables(table)
    G, q = t["G"], t["q"]
    B, N = llr.shape
    post = llr_to_post(llr.astype(jnp.float32), G, q)

    layers = t["layers"]

    col0 = (jax.lax.broadcasted_iota(jnp.int32, (LANES, B), 0) == 0)

    def roll(x, s):
        return jnp.roll(x, s, axis=0) if s else x

    def sweep(carry, _):
        post, msgs = carry
        msgs = list(msgs)
        for r in range(q):
            entries = layers[r]
            D = len(entries) + 2
            old = msgs[r].astype(jnp.float32)           # [D, 360, B]
            vals = []
            for e, (g, s) in enumerate(entries):
                vals.append(roll(post[g], s))
            vals.append(post[G + r])
            prev = roll(post[G + q - 1], 1) if r == 0 else post[G + r - 1]
            vals.append(prev)
            v = jnp.stack(vals) - old                   # [D, 360, B]
            a = jnp.abs(v)
            neg = (v < 0)
            if r == 0:
                a = a.at[D - 1].set(jnp.where(col0, 1e30, a[D - 1]))
                neg = neg.at[D - 1].set(jnp.where(col0, False, neg[D - 1]))
            m1 = jnp.min(a, axis=0)
            am = jnp.argmin(a, axis=0)
            onehot = jax.lax.broadcasted_iota(jnp.int32, (D, LANES, B), 0) \
                == am[None]
            m2 = jnp.min(jnp.where(onehot, 1e30, a), axis=0)
            nneg = jnp.sum(neg.astype(jnp.int32), axis=0)
            stot = 1.0 - 2.0 * (nneg % 2).astype(jnp.float32)
            sg = jnp.where(neg, -1.0, 1.0)
            excl = jnp.where(onehot, m2[None], m1[None])
            news = stot[None] * sg * jnp.maximum(excl - beta, 0.0)
            if r == 0:
                news = news.at[D - 1].set(
                    jnp.where(col0, 0.0, news[D - 1]))
            # quantize first so posterior and stored messages stay consistent
            news_q = news.astype(jnp.bfloat16)
            delta = news_q.astype(jnp.float32) - old
            msgs[r] = news_q
            for e, (g, s) in enumerate(entries):
                post = post.at[g].add(roll(delta[e], -s))
            post = post.at[G + r].add(delta[D - 2])
            if r == 0:
                post = post.at[G + q - 1].add(roll(delta[D - 1], -1))
            else:
                post = post.at[G + r - 1].add(delta[D - 1])
        return (post, tuple(msgs)), 0

    def syndrome_bad(post):
        bad = jnp.zeros(B, jnp.int32) + (0 * post[0, 0, :]).astype(jnp.int32)
        for r in range(q):
            acc = jnp.zeros((LANES, B), jnp.int32)
            for (g, s) in layers[r]:
                acc += (roll(post[g], s) < 0).astype(jnp.int32)
            acc += (post[G + r] < 0).astype(jnp.int32)
            prev = roll(post[G + q - 1], 1) if r == 0 else post[G + r - 1]
            prevneg = (prev < 0).astype(jnp.int32)
            if r == 0:
                prevneg = jnp.where(col0, 0, prevneg)
            acc += prevneg
            bad += jnp.sum(acc % 2, axis=0)
        return bad

    # data-tied zeros: keeps scan carry sharding consistent under shard_map
    zb = (0.0 * llr[0, 0]).astype(jnp.bfloat16)
    msgs0 = tuple(jnp.zeros((len(layers[r]) + 2, LANES, B), jnp.bfloat16) + zb
                  for r in range(q))

    # fixed iteration count: callers wanting early exit decode in two
    # passes (short first, rerun unconverged lanes longer)
    if track_trials:
        def step(carry, i):
            state, first_ok = carry
            state, _ = sweep(state, None)
            clean = syndrome_bad(state[0]) == 0
            first_ok = jnp.where((first_ok < 0) & clean, i + 1, first_ok)
            return (state, first_ok), 0

        first0 = jnp.full(B, -1, jnp.int32) + (0 * llr[:, 0]).astype(jnp.int32)
        ((post, msgs), first_ok), _ = jax.lax.scan(
            step, ((post, msgs0), first0), jnp.arange(n_iters))
        trials = jnp.where(first_ok < 0, n_iters, first_ok)
    else:
        (post, msgs), _ = jax.lax.scan(sweep, (post, msgs0), None,
                                       length=n_iters)
        trials = jnp.full(B, n_iters, jnp.int32) + \
            (0 * llr[:, 0]).astype(jnp.int32)
    bad = syndrome_bad(post)

    hard = post_to_hard(post, G, q)
    return hard, bad, trials


def reference_layered_decode(llr: np.ndarray, table: str, n_iters: int = 10,
                             beta: float = 2.0) -> np.ndarray:
    """Pure-numpy QC layered decode (golden model for decode_qc).
    llr [B, N] -> hard [B, N]."""
    t = qc_tables(table)
    G, q = t["G"], t["q"]
    post = to_qc_layout(llr.astype(np.float64), table)
    msgs = {}  # (r, e) -> [360, B]
    mask0 = np.ones((LANES, 1))
    mask0[0] = 0.0   # kill the wrap edge of layer 0's previous-parity input
    for it in range(n_iters):
        for r in range(q):
            entries = t["layers"][r]
            vals = []
            for e, (g, s) in enumerate(entries):
                m = msgs.get((r, e), 0.0)
                vals.append(np.roll(post[g], s, axis=0) - m)
            mp = msgs.get((r, "p"), 0.0)
            vals.append(post[G + r] - mp)
            mq = msgs.get((r, "pp"), 0.0)
            if r == 0:
                prev = np.roll(post[G + q - 1], 1, axis=0)
            else:
                prev = post[G + r - 1]
            vals.append(prev - mq)
            D = len(vals)
            a = np.stack([np.abs(v) for v in vals])
            sg = np.stack([np.where(v < 0, -1.0, 1.0) for v in vals])
            if r == 0:
                a[-1] = np.where(mask0 > 0, a[-1], 1e30)
                sg[-1] = np.where(mask0 > 0, sg[-1], 1.0)
            order = np.argsort(a, axis=0)
            m1 = np.take_along_axis(a, order[:1], 0)[0]
            m2 = np.take_along_axis(a, order[1:2], 0)[0]
            am = order[0]
            stot = np.prod(sg, axis=0)
            for e in range(D):
                excl = np.where(am == e, m2, m1)
                news = stot * sg[e] * np.maximum(excl - beta, 0.0)
                if r == 0 and e == D - 1:
                    news = news * mask0
                key = (r, e) if e < D - 2 else (r, "p") if e == D - 2 else (r, "pp")
                old = msgs.get(key, 0.0)
                delta = news - old
                msgs[key] = news
                # accumulate deltas (a group can appear twice in one layer)
                if e < D - 2:
                    g, s = entries[e]
                    post[g] = post[g] + np.roll(delta, -s, axis=0)
                elif e == D - 2:
                    post[G + r] = post[G + r] + delta
                else:
                    if r == 0:
                        post[G + q - 1] = post[G + q - 1] + np.roll(delta, -1, axis=0)
                    else:
                        post[G + r - 1] = post[G + r - 1] + delta
    return (from_qc_layout(post, table) < 0).astype(np.uint8)
