"""Per-frame carrier recovery: coarse FED + anchored feed-forward phase.

Replaces the reference's outer frequency feedback
(dvbs2_fed.h lag-2 differential estimator driving FreqShift with dual
gains, module_dvbs2_demod.cpp:318-331) and the per-symbol S2PLL
(dvbs2_pll.cpp:34-86) with batched per-frame estimates:

- coarse_fed: the same ETSI-guideline lag-2 differential frequency error
  over the known SOF/PLS symbols (and descrambled pilots), vectorized —
  but applied feed-forward to the frame itself rather than fed back.
- header_phase / pilot_phases: least-squares phase at the known-symbol
  anchors.
- qpsk_vv_phases: 4th-power Viterbi&Viterbi block phase for pilotless
  QPSK payloads, unwrapped from the header anchor.

DVB-S2 re-anchors phase at every SOF, which is what makes this
feed-forward formulation equivalent to the reference's closed loop
(SURVEY.md sec. 5).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import plheader, scrambling, modcod
from ..tx import dvbs2_mod


@functools.lru_cache()
def _header_syms(pls_code: int) -> np.ndarray:
    return plheader.plheader_symbols(pls_code)


@functools.lru_cache()
def _payload_descramble_phasors(n: int) -> np.ndarray:
    """conj(PL scrambler phasors) for a frame payload of n symbols."""
    return np.conj(scrambling.pl_scrambler_phasors()[:n])


@functools.lru_cache()
def _pilot_mask_and_payload_index(cfg_key: tuple):
    """For a pilots-on config: indices of payload symbols (post-header,
    pilots stripped) and start offsets of pilot blocks, both relative to
    the frame start."""
    cfg = modcod.get_config(*cfg_key)
    n_after = cfg.plframe_len - 90
    is_pilot = np.zeros(n_after, bool)
    for p in dvbs2_mod.pilot_symbol_positions(cfg):
        is_pilot[p - 90:p - 90 + 36] = True
    payload_idx = np.nonzero(~is_pilot)[0] + 90
    pilot_starts = dvbs2_mod.pilot_symbol_positions(cfg)
    return payload_idx.astype(np.int32), pilot_starts.astype(np.int32)


def payload_indices(cfg: modcod.ModcodConfig) -> np.ndarray:
    """Frame-relative indices of the nldpc/m payload symbols."""
    key = (cfg.modcod, cfg.framesize == modcod.SHORT, cfg.pilots)
    return _pilot_mask_and_payload_index(key)[0]


def pilot_starts(cfg: modcod.ModcodConfig) -> np.ndarray:
    key = (cfg.modcod, cfg.framesize == modcod.SHORT, cfg.pilots)
    return _pilot_mask_and_payload_index(key)[1]


def coarse_fed(frames: jax.Array, cfg: modcod.ModcodConfig) -> jax.Array:
    """Lag-2 differential frequency error estimate, rad/symbol.

    frames: [F, plframe_len]. Uses the 90 known header symbols (and the
    descrambled pilot blocks when present), following dvbs2_fed.h:7-48.
    """
    hdr = jnp.asarray(_header_syms(cfg.pls_code))
    h = frames[:, :90] * jnp.conj(hdr)[None, :]     # de-modulated header
    acc = jnp.sum(h[:, 2:] * jnp.conj(h[:, :-2]), axis=1)
    if cfg.pilots:
        ph = jnp.asarray(_payload_descramble_phasors(cfg.plframe_len - 90))
        pstarts = pilot_starts(cfg)
        pilot = (1 + 1j) / np.sqrt(2)
        for p in pstarts:
            blk = frames[:, p:p + 36] * ph[p - 90:p - 90 + 36] * np.conj(pilot)
            acc = acc + jnp.sum(blk[:, 2:] * jnp.conj(blk[:, :-2]), axis=1)
    # lag-2: each term rotates by exp(j*2f); complex averaging weighs by
    # amplitude (the reference sums Im parts only, dvbs2_fed.h:7-48)
    return jnp.angle(acc) / 2.0


def coarse_fed_common(frames: jax.Array, cfg: modcod.ModcodConfig,
                      robust: bool = False) -> jax.Array:
    """Block-common FED: all frames in a block share one carrier, so
    averaging the lag-2 accumulators across frames cuts the estimator
    noise by sqrt(F) — the feed-forward analogue of the reference's slow
    outer loop gain (fll_bw/100, module_dvbs2_demod.cpp:321-331).

    robust gates each frame's accumulator on its own coherence: a
    frame whose header does NOT match the configured PLS codeword (a
    dummy PLFRAME's differs in the 64 PLS symbols) sums its lag
    products incoherently, |acc| ~ sqrt(n) instead of ~n, and is
    excluded. If NO frame matches (an all-dummy block), the estimate
    is 0 — far closer to truth than the angle of noise (dummy_aware
    receivers; tests/test_dummy_frames.py)."""
    hdr = jnp.asarray(_header_syms(cfg.pls_code))
    h = frames[:, :90] * jnp.conj(hdr)[None, :]
    acc_f = jnp.sum(h[:, 2:] * jnp.conj(h[:, :-2]), axis=1)    # [F]
    nprod = 88.0
    if cfg.pilots:
        ph = jnp.asarray(_payload_descramble_phasors(cfg.plframe_len - 90))
        pstarts = pilot_starts(cfg)
        pilot = (1 + 1j) / np.sqrt(2)
        for p in pstarts:
            blk = frames[:, p:p + 36] * ph[p - 90:p - 90 + 36] * np.conj(pilot)
            acc_f = acc_f + jnp.sum(blk[:, 2:] * jnp.conj(blk[:, :-2]),
                                    axis=1)
            nprod += 34.0
    if robust:
        w = (jnp.abs(acc_f) > 0.35 * nprod).astype(acc_f.dtype)
        acc = jnp.sum(acc_f * w)
        return jnp.where(jnp.abs(acc) > 0, jnp.angle(acc) / 2.0, 0.0)
    return jnp.angle(jnp.sum(acc_f)) / 2.0


def lr_freq_common(frames: jax.Array, cfg: modcod.ModcodConfig,
                   M: int = 8, robust: bool = False) -> jax.Array:
    """Block-common Luise-Reggiannini frequency estimate over the known
    symbols (header + pilot blocks) of every frame.

    Multi-lag autocorrelation averaging: f = angle(sum_m R_m)/((M+1)/2).
    Far lower variance than the lag-2 FED at the same pull-in — needed
    because the feed-forward pilot-anchor unwrap requires
    |residual f| < pi/1476 (anchor spacing), which the 88-term FED cannot
    guarantee at threshold SNR.
    """
    hdr = jnp.asarray(_header_syms(cfg.pls_code))
    h = frames[:, :90] * jnp.conj(hdr)[None, :]
    segs = [h]
    if cfg.pilots:
        ph = jnp.asarray(_payload_descramble_phasors(cfg.plframe_len - 90))
        pilot = (1 + 1j) / np.sqrt(2)
        for p in pilot_starts(cfg):
            segs.append(frames[:, p:p + 36] * ph[p - 90:p - 90 + 36] *
                        np.conj(pilot))
    acc_f = jnp.zeros((frames.shape[0],), jnp.complex64)
    nprod = 0.0
    for m in range(1, M + 1):
        for seg in segs:
            acc_f = acc_f + jnp.sum(seg[:, m:] * jnp.conj(seg[:, :-m]),
                                    axis=1)
            nprod += seg.shape[1] - m
    if robust:
        # coherence-gated (see coarse_fed_common): mismatched-header
        # frames (dummies) are excluded; all-dummy blocks estimate 0
        w = (jnp.abs(acc_f) > 0.35 * nprod).astype(acc_f.dtype)
        acc = jnp.sum(acc_f * w)
        return jnp.where(jnp.abs(acc) > 0,
                         jnp.angle(acc) / ((M + 1) / 2.0), 0.0)
    return jnp.angle(jnp.sum(acc_f)) / ((M + 1) / 2.0)


def apply_freq(frames: jax.Array, freq: jax.Array) -> jax.Array:
    """Remove per-frame frequency offset (rad/symbol), phase-centered on
    symbol 0."""
    n = jnp.arange(frames.shape[1])
    rot = jnp.exp(-1j * freq[:, None] * n[None, :])
    return frames * rot.astype(frames.dtype)


def header_phase(frames: jax.Array, cfg: modcod.ModcodConfig) -> jax.Array:
    """LS phase over the 90 known header symbols. [F] float32."""
    hdr = jnp.asarray(_header_syms(cfg.pls_code))
    return jnp.angle(jnp.sum(frames[:, :90] * jnp.conj(hdr)[None, :], axis=1))


def _vv_group_phases(payload: jax.Array, theta0: jax.Array, group: int):
    """Unwrapped 4th-power phase per group. [F, G] (and group centers)."""
    F, P = payload.shape
    G = P // group
    z = payload[:, :G * group].reshape(F, G, group)
    z4 = jnp.sum(z ** 4, axis=2)                   # QPSK**4 removes data
    # QPSK^4 lands at angle 4*theta + pi (points at odd multiples of pi/4)
    raw = (jnp.angle(z4) - jnp.pi) / 4.0           # mod pi/2 ambiguity
    # unwrap = prefix sum, not a 360-step lax.scan: anchor group 0 at the
    # multiple of pi/2 nearest theta0, then accumulate the mod-(pi/2)
    # wrapped group-to-group steps — step-wise identical to the
    # sequential "round to previous" unwrap because the accumulated
    # correction is always an exact multiple of pi/2.
    half = jnp.pi / 2
    d = raw[:, 1:] - raw[:, :-1]
    d = d - jnp.round(d / half) * half
    base = raw[:, 0] + jnp.round((theta0 - raw[:, 0]) / half) * half
    phases = base[:, None] + jnp.concatenate(
        [jnp.zeros_like(raw[:, :1]), jnp.cumsum(d, axis=1)], axis=1)
    centers = (jnp.arange(G) + 0.5) * group
    return phases, centers                         # [F, G], [G]


def _interp_phases(phases: jax.Array, group: int, P: int) -> jax.Array:
    """Piecewise-linear interpolation of per-group phases [F, G] (group
    centers at (i+0.5)*group) onto the symbol grid [F, P], edge-clamped.

    Built by reshape/broadcast only — the jnp.interp this replaces is a
    binary-search gather per symbol."""
    F, G = phases.shape
    h = group // 2
    d = phases[:, 1:] - phases[:, :-1]                      # [F, G-1]
    frac = jnp.arange(group, dtype=jnp.float32) / group
    body = (phases[:, :-1, None] +
            d[:, :, None] * frac[None, None, :]).reshape(F, -1)
    head = jnp.broadcast_to(phases[:, :1], (F, h))
    tail_len = P - h - (G - 1) * group
    tail = jnp.broadcast_to(phases[:, -1:], (F, tail_len))
    return jnp.concatenate([head, body, tail], axis=1)


def qpsk_vv_phases(payload: jax.Array, theta0: jax.Array,
                   group: int = 360) -> jax.Array:
    """4th-power block phases for pilotless QPSK, anchored at theta0.

    payload: [F, P] descrambled payload symbols. Returns per-symbol phase
    [F, P] by unwrapping group estimates from the header anchor and
    linearly interpolating between group centers.
    """
    phases, _ = _vv_group_phases(payload, theta0, group)
    return _interp_phases(phases, group, payload.shape[1])


def qpsk_vv_track(payload: jax.Array, theta0: jax.Array) -> jax.Array:
    """Two-stage slip-resistant V&V for pilotless QPSK at threshold SNR.

    Stage 1: short groups (90 symbols) keep the per-group phase step well
    below the pi/4 unwrap limit even with a few mrad/symbol of residual
    CFO; a linear fit across the group phases extracts that residual.
    Stage 2: after removing the fitted ramp, long groups (720 symbols)
    give a low-noise phase track.  Returns per-symbol phase [F, P].
    """
    F, P = payload.shape
    ph1, c1 = _vv_group_phases(payload, theta0, 90)
    # per-frame linear fit (centered, float32-safe)
    c = c1 - jnp.mean(c1)
    denom = jnp.sum(c * c)
    slope = jnp.sum(c[None, :] * (ph1 - jnp.mean(ph1, 1, keepdims=True)),
                    axis=1) / denom                # [F] rad/symbol
    mean1 = jnp.mean(ph1, axis=1)
    ramp = mean1[:, None] + slope[:, None] * (
        jnp.arange(P, dtype=jnp.float32)[None, :] - jnp.mean(c1))
    flat = payload * jnp.exp(-1j * ramp).astype(payload.dtype)
    ph2, _ = _vv_group_phases(flat, jnp.zeros(F, jnp.float32), 720)
    return ramp + _interp_phases(ph2, 720, P)


def _dd_track_once(payload: jax.Array, theta0: jax.Array, pts: jax.Array,
                   group: int, n_iter: int) -> jax.Array:
    """One chained decision-directed pass; returns phase [F, P]."""
    F, P = payload.shape
    G = P // group
    z = payload[:, :G * group].reshape(F, G, group)
    centers = (jnp.arange(G) + 0.5) * group

    def refine(zg, ph):
        """n_iter decision-directed refinements of one group's phase."""
        for _ in range(n_iter):
            zc = zg * jnp.exp(-1j * ph)[:, None]
            d = jnp.abs(zc[..., None] - pts[None, None, :])
            ref = pts[jnp.argmin(d, axis=-1)]
            ph = ph + jnp.angle(jnp.sum(zc * jnp.conj(ref), axis=-1))
        return ph

    def step(carry_ph, zg):
        # chain: each group starts from the previous group's estimate so
        # residual CFO drift never exceeds the decision regions
        ph = refine(zg, carry_ph)
        return ph, ph

    z_t = jnp.swapaxes(z, 0, 1)                         # [G, F, group]
    carry0 = theta0 + 0.0 * z[:, 0, 0].real
    _, phases = jax.lax.scan(step, carry0, z_t)
    return _interp_phases(jnp.swapaxes(phases, 0, 1), group, P)


def dd_phase_track(payload: jax.Array, theta0: jax.Array, kind: str,
                   g1: float | None = None, g2: float | None = None,
                   group: int = 60, n_iter: int = 3,
                   freq_refine: bool = True) -> jax.Array:
    """Decision-directed feed-forward phase track for any constellation.

    For pilotless higher-order modes (the reference tracks these with its
    closed-loop LUT PLL, dvbs2_pll.cpp:34-86): per group, derotate by the
    current estimate, hard-decide the nearest constellation point, and
    re-estimate the group phase from sum z*conj(decision); iterate.
    Unwrap is anchored at theta0 (the header phase).

    With freq_refine (default), a second pass runs after removing the
    residual carrier measured from the FIRST pass's phase trajectory
    (median of per-group phase steps — robust to decision slips). The
    header-only L&R estimate leaves ~1e-3 rad/symbol of frequency noise
    in pilotless frames; the per-group phase step it causes sits near
    the 8PSK decision region, and the refined pass buys ~5 dB of
    pilotless 8PSK sensitivity (tests/test_dvbs2_higher_order.py).

    payload: [F, P]. Returns per-symbol phase [F, P].
    """
    from ..spec import constellations
    pts = jnp.asarray(constellations.points(kind, g1, g2))
    F, P = payload.shape
    ph1 = _dd_track_once(payload, theta0, pts, group, n_iter)
    if not freq_refine:
        return ph1
    G = P // group
    gp = ph1[:, ::group][:, :G]
    freq = jnp.median(gp[:, 1:] - gp[:, :-1], axis=1) / group    # [F]
    ramp = freq[:, None] * jnp.arange(P)[None, :]
    pay2 = payload * jnp.exp(-1j * ramp).astype(payload.dtype)
    return ramp + _dd_track_once(pay2, theta0, pts, group, n_iter)


def extract_payload(frames: jax.Array, cfg: modcod.ModcodConfig
                    ) -> jax.Array:
    """Pilots-on payload extraction [..., L] -> [..., P] as static
    slices + concat (the pilot grid is uniform, so the `[:, payload_idx]`
    fancy-index this replaces — a gather — is just the
    1440-symbol stretches between pilot blocks). Equality with the
    index form is asserted in tests/test_spec.py."""
    ps = pilot_starts(cfg)
    L = cfg.plframe_len
    chunks = [frames[..., 90:int(ps[0])]]
    for k in range(len(ps)):
        end = int(ps[k + 1]) if k + 1 < len(ps) else L
        chunks.append(frames[..., int(ps[k]) + 36:end])
    return jnp.concatenate(chunks, axis=-1)


def pilot_anchor_phases(frames: jax.Array, cfg: modcod.ModcodConfig,
                        theta0: jax.Array) -> jax.Array:
    """Piecewise-linear phase over the frame from header + pilot anchors.

    Pilot blocks sit on a uniform grid (first + k*1476, EN 302 307-1
    sec. 5.5.3), so the whole computation is batched: one reshape
    extracts every pilot block, the anchor-to-anchor unwrap is a
    round+cumsum prefix sum, and the interpolation is a structured
    reshape/broadcast build (no jnp.interp gather, no sequential
    per-pilot python loop — the 8PSK+pilots bank block was paying ~2x
    the QPSK block time partly here).

    Returns per-symbol phase for the full frame [F, plframe_len].
    """
    F, L = frames.shape
    ph = jnp.asarray(_payload_descramble_phasors(L - 90))
    pstarts = pilot_starts(cfg)
    pilot = (1 + 1j) / np.sqrt(2)
    n_p = len(pstarts)
    p0 = int(pstarts[0])
    step = int(pstarts[1] - pstarts[0]) if n_p > 1 else 1476
    assert n_p == 1 or (np.diff(pstarts) == step).all(), "non-uniform pilots"
    # all pilot blocks in one reshape (+ the matching descramble consts)
    span = (n_p - 1) * step + 36
    blks = jax.lax.slice(frames, (0, p0), (F, p0 + span))
    blks = jnp.concatenate(
        [blks, jnp.zeros((F, n_p * step - span), frames.dtype)], axis=1
    ).reshape(F, n_p, step)[:, :, :36]
    dphs = np.stack([np.asarray(_payload_descramble_phasors(L - 90))
                     [p - 90:p - 90 + 36] for p in pstarts])   # [n_p, 36]
    blks = blks * jnp.asarray(dphs)[None] * np.conj(pilot)
    raw = jnp.angle(jnp.sum(blks, axis=2))                      # [F, n_p]
    # unwrap to the header anchor: prefix sum of wrapped steps
    two_pi = 2 * jnp.pi
    d = raw[:, 1:] - raw[:, :-1]
    d = d - jnp.round(d / two_pi) * two_pi
    base = raw[:, :1] - jnp.round((raw[:, :1] - theta0[:, None]) / two_pi
                                  ) * two_pi
    vals = jnp.concatenate(
        [theta0[:, None], base + jnp.concatenate(
            [jnp.zeros_like(base), jnp.cumsum(d, axis=1)], axis=1)], axis=1)
    # anchors: 45 (header), then p0+18 + k*step. Piecewise-linear with
    # edge clamp, built per region (reshape/broadcast only).
    a1 = p0 + 18
    t_head = jnp.arange(a1, dtype=jnp.float32)
    w = jnp.clip((t_head - 45.0) / (a1 - 45.0), 0.0, 1.0)
    head = vals[:, :1] + (vals[:, 1:2] - vals[:, :1]) * w[None, :]
    dmid = vals[:, 2:] - vals[:, 1:-1]                          # [F, n_p-1]
    frac = jnp.arange(step, dtype=jnp.float32) / step
    mid = (vals[:, 1:-1, None] + dmid[:, :, None] * frac[None, None, :]
           ).reshape(F, -1)
    tail_len = L - a1 - (n_p - 1) * step
    # tail: extrapolate at the anchor-track slope instead of clamping
    # flat. The block-common L&R freq leaves up to ~5e-4 rad/symbol of
    # residual (worst mid-estimate CFOs); a flat tail accrues that over
    # the ~1.5k unanchored symbols after the last pilot to >0.5 rad —
    # past the 32APSK decision regions (the round-4 bench 32APSK gate
    # failure).
    # The full-span anchor slope measures the residual at ~3e-6
    # rad/symbol noise (14.5 dB), so extrapolation is ~free. The
    # reference's per-symbol PLL free-runs its frequency state through
    # the same region (dvbs2_pll.cpp:34-86) — this matches that.
    span_steps = max(n_p - 1, 1)
    if n_p > 1:
        slope = (vals[:, -1:] - vals[:, 1:2]) / (span_steps * step)
    else:
        slope = (vals[:, 1:2] - vals[:, :1]) / float(a1 - 45)
    t_tail = jnp.arange(tail_len, dtype=jnp.float32)
    tail = vals[:, -1:] + slope * t_tail[None, :]
    return jnp.concatenate([head, mid, tail], axis=1)


def derotate(x: jax.Array, phase: jax.Array) -> jax.Array:
    return x * jnp.exp(-1j * phase).astype(x.dtype)
