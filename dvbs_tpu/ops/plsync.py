"""DVB-S2 PL frame synchronization (feed-forward, batched).

Differential SOF+PLS correlation over every symbol offset — the same
detection statistic as the reference's S2PLSyncBlock
(/root/reference/src/demod/dvbs2/dvbs2_pl_sync.cpp:102-193) but computed
for all offsets at once as two 90-tap correlations (one matmul-shaped
convolution each) instead of a per-offset volk loop, and with frame
extraction as batched dynamic slices instead of the two-phase
realign state machine.

CFO-robust: |c| is invariant to a constant frequency offset, and the
offset rotates c's phase away from +j — the same "d.im > 0" gate as the
reference (with the CFO pre-corrected upstream, genuine peaks keep
positive imaginary part).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import plheader


@functools.lru_cache()
def _templates():
    sof_t, pls_t = plheader.header_diff_templates()
    return sof_t, pls_t


_CORR_BLK = 512


@functools.lru_cache()
def _template_matrix(blk: int) -> np.ndarray:
    """Banded correlation matrix T [blk+89, 2*blk] float32 with
    T[j, 2*col + t] = temp_t[j - col]; windows @ T computes both header
    correlations for blk consecutive offsets as ONE matmul."""
    sof_t, pls_t = _templates()
    T = np.zeros((blk + 89, 2 * blk), np.float32)
    for col in range(blk):
        T[col:col + 90, 2 * col] = sof_t
        T[col:col + 90, 2 * col + 1] = pls_t
    return T


def correlate(z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Differential header correlation at every offset.

    z: [n] complex symbols. Returns (score [n-89] float32 in [0,~1],
    cvec [n-89] complex64 — the chosen correlation value, whose angle
    carries the residual CFO x 1 symbol).

    Computed as matrix products: the differential stream is cut into
    overlapping [blk+89] windows and multiplied by a banded +-1
    template matrix (both templates as interleaved columns), two real
    [nb, blk+89] @ [blk+89, 2*blk] matmuls in bf16 with f32
    accumulation (bf16 operands chosen explicitly, so no TF32 question),
    instead of 90 sliced vector adds per template; the matmul is ~5
    GFLOP for a 131k-symbol carrier block x 8 carriers.
    """
    d = jnp.concatenate([jnp.zeros(1, z.dtype), z[1:] * jnp.conj(z[:-1])])
    n = d.shape[0]
    nout = n - 89
    # blk must be >= 89 so two adjacent rows cover a full window
    blk = min(_CORR_BLK, max(128, nout))
    nb = -(-nout // blk)
    dp = jnp.pad(d, (0, (nb + 1) * blk - n)) if (nb + 1) * blk > n \
        else d[:(nb + 1) * blk]
    a = dp.reshape(nb + 1, blk)
    # window rows: dp[i*blk : i*blk + blk + 89] = row i || row i+1
    w = jnp.concatenate([a[:-1], a[1:]], axis=1)[:, :blk + 89]
    T = jnp.asarray(_template_matrix(blk), jnp.bfloat16)
    re = jnp.dot(jnp.real(w).astype(jnp.bfloat16), T,
                 preferred_element_type=jnp.float32).reshape(nb, blk, 2)
    im = jnp.dot(jnp.imag(w).astype(jnp.bfloat16), T,
                 preferred_element_type=jnp.float32).reshape(nb, blk, 2)
    csof = (re[..., 0] + 1j * im[..., 0]).reshape(nb * blk)[:nout]
    cpls = (re[..., 1] + 1j * im[..., 1]).reshape(nb * blk)[:nout]
    c0 = csof + cpls      # pilots-off PLS parity
    c1 = csof - cpls      # pilots-on PLS parity
    pick1 = jnp.abs(c1) > jnp.abs(c0)
    c = jnp.where(pick1, c1, c0) / (25.0 + 32.0)
    return jnp.abs(c).astype(jnp.float32), c.astype(jnp.complex64)


def locate_frames(score: jax.Array, frame_len: int, n_frames: int,
                  search: int = 4, margin: int = 0,
                  fallback_threshold: float = 0.6):
    """Pick frame starts: global argmax in the window
    [margin, margin + frame_len), then per-frame local refinement within
    +-search symbols.  margin keeps the first frame clear of block-edge
    filter/timing-warm-up transients.

    Per-frame relocation fallback: any frame whose refined quality sits
    below `fallback_threshold` re-locates from a full frame-length
    window centered on its expected start, instead of trusting the
    periodic extrapolation — the batched analogue of the reference's
    per-frame re-correlate + two-phase realign
    (dvbs2_pl_sync.cpp:102-161): one noise peak in the first window, a
    timing jump, or a non-uniform gap then costs the affected frames
    only, not the whole block.

    Returns (starts [n_frames] int32, quality [n_frames] float32).
    """
    p0 = margin + jnp.argmax(
        jax.lax.dynamic_slice(score, (margin,), (frame_len,))).astype(jnp.int32)
    base = p0 + jnp.arange(n_frames, dtype=jnp.int32) * frame_len

    offs = jnp.arange(-search, search + 1, dtype=jnp.int32)
    cand = base[:, None] + offs[None, :]
    cand = jnp.clip(cand, 0, score.shape[0] - 1)
    vals = score[cand]                         # [F, 2*search+1]
    best = jnp.argmax(vals, axis=1)
    starts = jnp.take_along_axis(cand, best[:, None], axis=1)[:, 0]
    quality = jnp.take_along_axis(vals, best[:, None], axis=1)[:, 0]

    if fallback_threshold is not None:
        lo = jnp.clip(base - frame_len // 2, 0,
                      score.shape[0] - frame_len)
        win = jax.vmap(lambda l: jax.lax.dynamic_slice(
            score, (l,), (frame_len,)))(lo)    # [F, frame_len]
        ridx = jnp.argmax(win, axis=1).astype(jnp.int32)
        rstart = lo + ridx
        rq = jnp.take_along_axis(win, ridx[:, None], axis=1)[:, 0]
        # only frames whose window sits FULLY inside their own
        # L-periodic territory may relocate: near the block edges the
        # clip shifts the window onto a neighbour's SOF and the frame
        # would decode as a duplicate — which corrupts the TS parser's
        # byte continuity (duplicate SYNCD mid-stream)
        territory_ok = (base - frame_len // 2 >= 0) & \
            (base + frame_len // 2 <= score.shape[0] - frame_len)
        use = (quality < fallback_threshold) & (rq > quality) & \
            territory_ok
        starts = jnp.where(use, rstart, starts)
        quality = jnp.where(use, rq, quality)
    return starts, quality


DUMMY_LEN = 90 + 36 * 90     # dummy PLFRAME (EN 302 307-1 sec. 5.5.1)


def locate_frames_chain(score: jax.Array, frame_len: int, n_frames: int,
                        search: int = 4, margin: int = 0,
                        threshold: float = 0.6):
    """Sequentially-chained frame slotting for NON-UNIFORM grids
    (dummy PLFRAMEs interleaved with data, dummy_aware receivers).

    The parallel locator (locate_frames) assumes an L-periodic grid; a
    dummy PLFRAME is only DUMMY_LEN symbols, so streams with dummies
    have more SOFs than L-periodic slots and un-slotted data frames
    get skipped at block seams.  Here each slot chains from the
    previous slot's refined position over the candidate pitches
    {DUMMY_LEN, L, L+DUMMY_LEN, L+2*DUMMY_LEN} (a dummy occupies its
    own slot; its pitch to the next SOF is DUMMY_LEN), picking the
    EARLIEST candidate whose refined correlation clears `threshold` —
    the batched analogue of the reference's frame-by-frame realign
    (dvbs2_pl_sync.cpp:145-161), which never skips a SOF.  Falls back
    per-slot to the best candidate when none clears the threshold.

    Cost: a lax.scan of n_frames tiny gather steps — only used by
    dummy_aware receivers (opt-in), the default stays the fully
    parallel locator.  Returns (starts [n_frames], quality [n_frames]).
    """
    L = frame_len
    n = score.shape[0]
    p0 = margin + jnp.argmax(
        jax.lax.dynamic_slice(score, (margin,), (L,))).astype(jnp.int32)
    offs = jnp.arange(-search, search + 1, dtype=jnp.int32)
    pitches = jnp.asarray([DUMMY_LEN, L, L + DUMMY_LEN, L + 2 * DUMMY_LEN],
                          jnp.int32)

    def refine(pos):
        c = jnp.clip(pos + offs, 0, n - 1)
        v = score[c]
        k = jnp.argmax(v)
        return c[k], v[k]

    def step(prev, _):
        prev = prev + 0 * score[0].astype(jnp.int32)   # data-tied carry
        cand = prev + pitches
        cc = jnp.clip(cand[:, None] + offs[None, :], 0, n - 1)
        v = score[cc]                                  # [4, 2*search+1]
        q = jnp.max(v, axis=1)
        r = jnp.argmax(v, axis=1)
        above = q > threshold
        any_above = jnp.any(above)
        first = jnp.argmax(above)                      # earliest above
        besti = jnp.argmax(q)
        i = jnp.where(any_above, first, besti)
        nxt = cc[i, r[i]].astype(jnp.int32)
        return nxt, (nxt, q[i])

    s0, q0 = refine(p0)
    _, (rest, rq) = jax.lax.scan(step, s0, None, length=n_frames - 1)
    starts = jnp.concatenate([s0[None], rest])
    quality = jnp.concatenate([q0[None], rq])
    return starts.astype(jnp.int32), quality.astype(jnp.float32)


def extract_frames(z: jax.Array, starts: jax.Array, frame_len: int
                   ) -> jax.Array:
    """Batched dynamic slice: frames [F, frame_len] from symbol stream."""
    def one(s):
        return jax.lax.dynamic_slice(z, (s,), (frame_len,))
    return jax.vmap(one)(starts)
