"""Sample-domain front end: AGC, mixer, matched filter, timing recovery.

Feed-forward, block-parallel replacements for the reference's per-sample
feedback loops (SURVEY.md sec. 5 "long-context"):

- AGC: block power normalization (vs FastAGC's per-sample recursion,
  agc_rate=1e-4 — converges to the same fixed point).
- Carrier: lag-1 autocorrelation coarse CFO estimator + open-loop NCO
  (vs FLL band-edge / outer FED feedback driving FreqShift,
  module_dvbs2_demod.cpp:318-331).
- Matched filter: direct FIR convolution (65-tap RRC, alpha=0.35).
- Timing: Oerder-Meyr square-law estimator on a 2x interpolated stream
  (vs Gardner's 128-phase polyphase + sign-ML feedback loop,
  gardner.cpp:89-149), then one polyphase interpolation to the symbol
  grid.  Block-feed-forward: no recurrences, fully batchable.

All functions are jit-friendly: static shapes, no data-dependent Python
control flow.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..tx.channel import rrc_taps  # same pulse both sides (matched pair)


def agc(x: jax.Array) -> jax.Array:
    """Normalize block to unit average power."""
    p = jnp.mean(jnp.abs(x) ** 2)
    return x * jax.lax.rsqrt(p + 1e-12)


def pack_cs4(samples: np.ndarray, scale: float = 2.5) -> np.ndarray:
    """Host-side: complex baseband -> packed 4-bit IQ, 1 byte/sample
    (I in the high nibble, Q in the low). `scale` is the target rms in
    LSBs; 2.5 leaves ~2.8 sigma of clip headroom in the +-7 range. At
    the 5 dB QPSK operating point, 4-bit quantization costs ~0 extra
    LDPC trials (AGC renormalizes, so absolute scale is free) — it
    exists to halve ingest transport bytes vs cs8."""
    s = np.asarray(samples)
    rms = np.sqrt(np.mean(np.abs(s) ** 2)) + 1e-30
    q = np.clip(np.round(np.stack([s.real, s.imag]) * (scale / rms)),
                -7, 7).astype(np.int64)
    return (((q[0] & 15) << 4) | (q[1] & 15)).astype(np.uint8)


def unpack_cs4(packed: jax.Array) -> jax.Array:
    """Device-side inverse of pack_cs4: uint8 [..., n] -> int8
    [..., 2, n] (stacked re/im, sign-extended 4-bit values)."""
    hi = ((packed >> 4) ^ 8).astype(jnp.int8) - 8
    lo = ((packed & 15) ^ 8).astype(jnp.int8) - 8
    return jnp.stack([hi, lo], axis=-2)


def pack_bits_to_bytes(bits: jax.Array) -> jax.Array:
    """Device-side MSB-first bit packing: [..., 8k] {0,1} -> [..., k]
    uint8, as a float dot against [128..1]."""
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.float32)
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    # exact at any precision (TF32 included): 0/1 times powers of two,
    # sums <= 255
    return jnp.dot(b.astype(jnp.float32), w,
                   precision=jax.lax.Precision.DEFAULT,
                   preferred_element_type=jnp.float32).astype(jnp.uint8)


def coarse_cfo_estimate(x: jax.Array) -> jax.Array:
    """CFO in rad/sample from the lag-1 autocorrelation.

    At 2 samples/symbol the half-symbol-lag autocorrelation of an
    RRC-shaped PSK signal is real-positive up to the CFO rotation, so
    angle(sum x[n] conj(x[n-1])) estimates the per-sample CFO with +-pi
    pull-in.
    """
    r = jnp.sum(x[1:] * jnp.conj(x[:-1]))
    return jnp.angle(r)


def qpsk_residual_freq(z: jax.Array) -> jax.Array:
    """Residual carrier frequency of a QPSK symbol stream, rad/symbol.

    4th-power spectral line: the peak bin of FFT(z^4) sits at 4x the
    residual frequency. Parabolic interpolation refines to a small
    fraction of a bin; pull-in +-pi/4 rad/symbol. This is the
    feed-forward replacement for the FLL/Costas frequency acquisition the
    reference runs per sample (fll.cpp:135-149).
    """
    n = z.shape[-1]
    spec = jnp.abs(jnp.fft.fft(z ** 4))
    k = jnp.argmax(spec)
    km = (k - 1) % n
    kp = (k + 1) % n
    a, b, c = spec[km], spec[k], spec[kp]
    delta = 0.5 * (a - c) / (a - 2 * b + c + 1e-12)
    kf = k + jnp.clip(delta, -0.5, 0.5)
    kf = jnp.where(kf > n / 2, kf - n, kf)   # signed frequency
    return (2 * jnp.pi * kf / n) / 4.0


def mix(x: jax.Array, freq: jax.Array, phase: jax.Array = 0.0) -> jax.Array:
    """Open-loop NCO: multiply by exp(-j(freq*n + phase)) (FreqShift
    equivalent, freq in rad/sample)."""
    n = jnp.arange(x.shape[-1])
    return x * jnp.exp(-1j * (freq * n + phase)).astype(x.dtype)


_FIR_BLK = 256


@functools.lru_cache()
def _fir_matrix(taps_key, blk: int) -> np.ndarray:
    """Banded FIR matrix T [blk+K-1, blk] with T[j, col] = taps[j-col]:
    windows @ T evaluates the centered FIR for blk consecutive outputs
    as one matmul (as plsync._template_matrix does)."""
    taps = np.asarray(taps_key, np.float32)
    K = len(taps)
    T = np.zeros((blk + K - 1, blk), np.float32)
    for col in range(blk):
        T[col:col + K, col] = taps
    return T


def fir_filter(x: jax.Array, taps: np.ndarray,
               bf16: bool = True) -> jax.Array:
    """Centered FIR ('same' length). Complex in, real taps.

    Long filters on long blocks run as matrix products: overlapping
    [blk+K-1] windows of the padded input times a banded tap matrix.
    bf16=True (default) runs them as bf16 operands with f32
    accumulation — at the receiver's operating point the input is
    4..8-bit quantized IQ well below the AWGN floor, so the bf16
    rounding (8-bit mantissa per product) is invisible next to channel
    noise. This covers every matmul-path caller — the RRC matched
    filter AND the timing-recovery interpolators (_mid_taps K=24,
    _halfband_taps K=47); the bf16 error bound is asserted on all three
    tap sets in tests/test_frontend_ops.py. bf16=False keeps f32 at
    HIGHEST precision (no TF32 rounding). Short filters/blocks use
    static shift-and-add (K shifted multiply-adds).
    """
    taps = np.asarray(taps, np.float32)
    K = len(taps)
    n = x.shape[-1]
    half = K // 2
    blk = _FIR_BLK
    if K >= 16 and n >= 4 * blk and K - 1 <= blk:
        nb = -(-n // blk)
        xp = jnp.pad(x, (half, (nb + 1) * blk - n - half))
        a = xp.reshape(nb + 1, blk)
        w = jnp.concatenate([a[:-1], a[1:]], axis=1)[:, :blk + K - 1]
        T = jnp.asarray(_fir_matrix(tuple(taps.tolist()), blk))
        if bf16:
            T = T.astype(jnp.bfloat16)
            dot = functools.partial(
                jnp.dot, preferred_element_type=jnp.float32)
            wr = jnp.real(w).astype(jnp.bfloat16)
            wi = jnp.imag(w).astype(jnp.bfloat16)
        else:
            dot = functools.partial(jnp.dot,
                                    precision=jax.lax.Precision.HIGHEST,
                                    preferred_element_type=jnp.float32)
            wr, wi = jnp.real(w), jnp.imag(w)
        # one matmul for re+im (rows are independent): [2nb, blk+K-1] x
        # [blk+K-1, blk] — identical numerics, half the dispatches
        y = dot(jnp.concatenate([wr, wi], axis=0), T)
        re = y[:nb].reshape(nb * blk)[:n]
        im = y[nb:].reshape(nb * blk)[:n]
        return (re + 1j * im).astype(jnp.complex64)
    xp = jnp.pad(x, (half, K - 1 - half))
    acc = jnp.zeros(n, x.dtype)
    for j, h in enumerate(taps.tolist()):
        if h != 0.0:
            acc = acc + h * xp[j:j + n]
    return acc.astype(jnp.complex64)


def matched_filter(x: jax.Array, ntaps: int = 65, alpha: float = 0.35,
                   sps: float = 2.0) -> jax.Array:
    return fir_filter(x, rrc_taps(ntaps, alpha, sps))


# ---------------------------------------------------------------------------
# Timing recovery
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _halfband_taps(n: int = 47) -> np.ndarray:
    """Interpolate-by-2 filter (windowed sinc at half-integer offsets)."""
    k = np.arange(n) - n // 2
    h = np.sinc(k / 2.0) * np.blackman(n)
    return (h / h[n // 2] * 0.5).astype(np.float32)


@functools.lru_cache()
def _mid_taps(n: int = 24) -> np.ndarray:
    """Half-sample-offset interpolator: v[m] ~ y(m + 0.5).

    fir_filter applies taps[j] at offset u = j - n//2, so the taps must be
    sinc(u - 0.5) (interpolation kernel evaluated at 0.5 - u is symmetric).
    """
    u = np.arange(n) - n // 2
    t = u - 0.5
    w = 0.54 + 0.46 * np.cos(np.pi * t / (n / 2))
    h = np.sinc(t) * np.where(np.abs(t) <= n / 2, w, 0.0)
    return (h / h.sum()).astype(np.float32)


def _oerder_meyr_terms(y2: jax.Array) -> jax.Array:
    """Per-sample complex contributions to the Oerder-Meyr tone.

    Interpolating to 4 sps and summing |u_n|^2 exp(-j pi n/2) is
    equivalent to sum_m (-1)^m (|y_m|^2 - j |v_m|^2) with v the
    half-sample interpolant — one shared FIR pass for the whole block.
    """
    v = fir_filter(y2, _mid_taps())
    m = jnp.arange(y2.shape[-1])
    sgn = 1.0 - 2.0 * (m % 2).astype(jnp.float32)
    return sgn * (jnp.abs(y2) ** 2 - 1j * jnp.abs(v) ** 2)


def oerder_meyr_tau(y2: jax.Array) -> jax.Array:
    """Timing phase from a 2 sps block. Returns tau in [-0.5, 0.5)
    symbols; symbol instants sit at 2 sps positions 2k - 2*tau."""
    s = jnp.sum(_oerder_meyr_terms(y2))
    return jnp.angle(s) / (2 * jnp.pi)


@functools.lru_cache()
def interp_bank(n_phases: int = 128, n_taps: int = 8) -> np.ndarray:
    """Windowed-sinc polyphase interpolator bank [n_phases, n_taps]
    (same structure as the reference's Gardner bank, gardner.h:29)."""
    bank = np.zeros((n_phases, n_taps), np.float32)
    half = n_taps / 2.0
    for p in range(n_phases):
        mu = p / n_phases
        k = np.arange(n_taps) - (n_taps // 2 - 1)
        t = k - mu
        w = 0.54 + 0.46 * np.cos(np.pi * t / half)   # Hamming centered on t=0
        h = np.sinc(t) * np.where(np.abs(t) <= half, w, 0.0)
        bank[p] = h / h.sum()
    return bank


def resample_at(y: jax.Array, t: jax.Array, n_phases: int = 128,
                n_taps: int = 8) -> jax.Array:
    """Evaluate y (uniform grid) at fractional positions t via the
    polyphase bank. Positions outside the valid range clamp."""
    bank = jnp.asarray(interp_bank(n_phases, n_taps))
    i0 = jnp.floor(t).astype(jnp.int32)
    mu = t - i0
    ph = jnp.clip(jnp.round(mu * n_phases).astype(jnp.int32), 0, n_phases - 1)
    base = i0 - (n_taps // 2 - 1)
    offs = jnp.arange(n_taps)
    idx = jnp.clip(base[:, None] + offs[None, :], 0, y.shape[-1] - 1)
    taps = bank[ph]                                   # [M, n_taps]
    return jnp.sum(y[idx] * taps, axis=-1).astype(jnp.complex64)


_RESAMPLE_SPAN = 4    # max |t(k) - 2k| the gather-free resampler supports


def resample_half_grid(y: jax.Array, t: jax.Array, S_out: int,
                       n_phases: int = 128, n_taps: int = 8) -> jax.Array:
    """Gather-free polyphase resampling on rebased windows (batched).

    y: [..., >= 2*S_out + 6*_RESAMPLE_SPAN] samples; t: [..., S_out]
    positions into y (per leading-dim window) with t[k] - 2k in
    [_RESAMPLE_SPAN, 3*_RESAMPLE_SPAN] (the caller rebases so the drift
    fits this band).  The 8-tap window is assembled by one-hot
    selection over contiguous even/odd-phase slices, and the per-symbol
    filter comes from a one-hot [..., n_phases] matmul against the bank.
    Only tests exercise this path — the hot path is the barrel-shifter
    + Farrow formulation in resample_windowed; this is kept as the
    independently-validated brute-force oracle
    (tests/test_frontend_ops.py).
    """
    SP = _RESAMPLE_SPAN
    S = S_out
    ye = y[..., 0::2]
    yo = y[..., 1::2]
    k = jnp.arange(S)
    i0 = jnp.floor(t).astype(jnp.int32)
    mu = t - i0
    ph = jnp.clip(jnp.round(mu * n_phases).astype(jnp.int32), 0, n_phases - 1)
    # tap j of output k sits at y-index 2k + (c + j) with candidate
    # c = i0 - (n_taps/2-1) - 2k in [c_lo, c_hi] (clip for safety)
    c_lo = SP - 1 - (n_taps // 2 - 1)
    c_hi = 3 * SP + 1 - (n_taps // 2 - 1)
    base = jnp.clip(i0 - (n_taps // 2 - 1) - 2 * k, c_lo, c_hi)
    onehot = base[..., None] == jnp.arange(c_lo, c_hi + 1)
    bank = jnp.asarray(interp_bank(n_phases, n_taps))  # [128, 8]
    ph1h = (ph[..., None] == jnp.arange(n_phases)).astype(jnp.float32)
    # a one-hot row selection: HIGHEST keeps the selected bank taps
    # exact (TF32 would round them to 10 mantissa bits)
    taps = jnp.dot(ph1h, bank, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)  # [..., S, 8]
    # window assembly by one-hot select
    out = jnp.zeros(t.shape, y.dtype)
    for j in range(n_taps):
        acc = jnp.zeros(t.shape, y.dtype)
        for ci, c in enumerate(range(c_lo, c_hi + 1)):
            idx = c + j
            src = ye[..., idx // 2: idx // 2 + S] if idx % 2 == 0 else \
                yo[..., idx // 2: idx // 2 + S]
            acc = acc + jnp.where(onehot[..., ci], src, 0.0)
        out = out + acc * taps[..., j]
    return out.astype(jnp.complex64)


def recover_symbols(y2: jax.Array, n_windows: int = 8,
                    tau_hint: jax.Array | None = None) -> tuple[jax.Array, jax.Array]:
    """Block feed-forward timing recovery at 2 sps.

    Estimates tau per sub-window (handles sample-clock drift across the
    block), unwraps, fits linearly, and interpolates one output symbol per
    2 input samples. Returns (symbols [n2//2], tau_path [n_windows]).

    tau_hint: expected tau at the block start (previous block's ending
    tau) — the unwrapped path is shifted by a whole number of symbols to
    meet it, which keeps the symbol grid continuous across blocks.
    """
    z, tau_u, _ = recover_symbols_full(y2, n_windows, tau_hint)
    return z, tau_u


def recover_symbols_full(y2: jax.Array, n_windows: int = 8,
                         tau_hint: jax.Array | None = None,
                         tau_eval: int | None = None):
    """As recover_symbols but also returns tau extrapolated to sample
    position `tau_eval` (default: the block end) — the tau_hint of a
    next block that starts there (streaming overlap consumes less than
    the whole block, parallel/dvbs_bank.DVBSBankStream)."""
    n2 = y2.shape[-1]
    win = (n2 // n_windows) & ~1   # even stride: odd sample offsets alias
    terms = _oerder_meyr_terms(y2)  # one shared interpolator pass
    taus = jnp.stack([
        jnp.angle(jnp.sum(terms[i * win:(i + 1) * win])) / (2 * jnp.pi)
        for i in range(n_windows)])
    # unwrap mod 1 symbol
    d = jnp.diff(taus)
    d = d - jnp.round(d)
    tau_u = taus[0] + jnp.concatenate([jnp.zeros(1), jnp.cumsum(d)])
    if tau_hint is not None:
        # NaN hint = "no hint" (first block)
        k = jnp.where(jnp.isnan(tau_hint), 0.0,
                      jnp.round(tau_hint - tau_u[0]))
        tau_u = tau_u + k
    # linear fit tau(n) on centered/scaled regressor (float32-safe)
    centers = (jnp.arange(n_windows) + 0.5) * win
    c0 = jnp.mean(centers)
    scale = centers[-1] - centers[0] + 1e-9
    u = (centers - c0) / scale
    slope = jnp.sum(u * (tau_u - jnp.mean(tau_u))) / jnp.sum(u * u)
    k = jnp.arange(n2 // 2)
    n_nom = 2.0 * k
    tau_line = jnp.mean(tau_u) + slope * (n_nom - c0) / scale
    # robustness: a timing STEP mid-block (cable swap, source restart)
    # breaks the global line — every symbol's grid would be off by up to
    # half the step. When the fit residual says the path isn't a line,
    # switch to piecewise-linear interpolation through the window
    # estimates (uniform centers -> pure reshape/broadcast, no gather):
    # only the window containing the step stays degraded, matching the
    # reference's loop-reconverges-in-one-burst behavior (gardner.cpp).
    resid = tau_u - (jnp.mean(tau_u) + slope * u)
    use_pw = jnp.max(jnp.abs(resid)) > 0.07
    d = tau_u[1:] - tau_u[:-1]                         # [W-1]
    # symbol-domain piecewise build (segment = win/2 symbols between
    # window centers; reshape/broadcast only, no gather). Falls back to
    # the line when the symbol grid doesn't tile cleanly.
    S_out = n2 // 2
    seg = win // 2
    pw_ok = win % 4 == 0 and seg * (n_windows - 1) + 2 * (seg // 2) == S_out
    if pw_ok:
        frac = jnp.arange(seg, dtype=jnp.float32) / seg
        body = (tau_u[:-1, None] + d[:, None] * frac[None, :]).reshape(-1)
        h = seg // 2
        head = tau_u[0] + d[0] * (jnp.arange(h, dtype=jnp.float32) - h) / seg
        tail = tau_u[-1] + d[-1] * jnp.arange(h, dtype=jnp.float32) / seg
        tau_pw_n = jnp.concatenate([head, body, tail])
        tau_n = jnp.where(use_pw, tau_pw_n, tau_line)
    else:
        tau_n = tau_line
    t = jnp.clip(n_nom - 2.0 * tau_n, 0.0, n2 - 1.0)
    pos = n2 if tau_eval is None else tau_eval
    tau_end = jnp.mean(tau_u) + slope * (pos - c0) / scale
    if pw_ok:
        tau_end_pw = tau_u[-1] + d[-1] * (pos - centers[-1]) / win
        tau_end = jnp.where(use_pw, tau_end_pw, tau_end)
    with jax.named_scope("resample"):
        z = resample_windowed(y2, t)
    return z, tau_u, tau_end


_MAX_SCO = 250e-6   # symbol-clock error the windowing must absorb


# ---------------------------------------------------------------------------
# Farrow resampler: per-tap polynomials in the fractional delay.
#
# The LUT-free successor of the one-hot polyphase selector: evaluating
# the (normalized) interpolation taps as polynomials of the continuous
# delay d costs ~100 f32 fused multiply-adds per symbol on [W, w]-shaped
# arrays — no one-hot matmul ([S, 128] f32 = 280 MB of memory traffic
# per carrier) and no candidate where-selects (88 masked passes over
# the stream). Accuracy: the fit residual is held below the
# bank's own 128-phase quantization error (asserted in
# tests/test_frontend_ops.py).
# ---------------------------------------------------------------------------

_FARROW_TAPS = 10          # candidates c = 0..9, y-index 2k + r - 4 + c
_FARROW_DEG = 9            # per-tap polynomial degree
_FARROW_LO, _FARROW_HI = 3.3, 4.7   # fitted band d = (g - r) + 4
# (band = 4 + mu with mu in [-0.5, 0.5] + in-tile drift 0.13 + slack)
_TILE_SYM = 256            # symbols per barrel tile (512 samples)
_SHIFT_BITS = 10           # MAX integer drift range: r + bias in [0, 1024)


def _shift_bits_for(n_symbols: int) -> int:
    """Barrel stages actually needed for a block of n_symbols.

    The integer delay r is bounded by the true drift the timing chain
    can produce: |tau| <= ~1.5 symbols (mod-1 estimate + hint-carry
    re-centering keeps the carried tau within +-0.5, dvbs_bank.py:509)
    plus the in-block SCO accumulation n_symbols * _MAX_SCO symbols,
    all times 2 samples/symbol, plus tile-granularity/Farrow slack.
    Sizing the barrel to this bound instead of the fixed 10-bit range
    removes the top stages AND their padding columns — each saved bit
    cuts one full [nt, width] masked pass and halves the extra width
    (the stage traffic that dominates the timing stage).
    Inputs whose drift exceeds the bound degrade exactly as before
    (rb is clipped; the quality gates reject those tiles' frames).
    """
    need = int(2 * (1.5 + n_symbols * _MAX_SCO)) + 8
    return max(6, min(_SHIFT_BITS, need.bit_length() + 1))


@functools.lru_cache()
def _farrow_coeffs(n_taps: int = 8):
    """LSQ per-candidate polynomial fit of the per-delay-NORMALIZED
    windowed-sinc kernel over the band. Returns ([TAPS, DEG+1] float32
    highest power first, mid, half) in u = (d - mid)/half coords."""
    d = np.linspace(_FARROW_LO, _FARROW_HI, 1024)
    half_sup = n_taps / 2.0
    vals = np.zeros((len(d), _FARROW_TAPS))
    for ci in range(_FARROW_TAPS):
        u = d - ci
        wnd = 0.54 + 0.46 * np.cos(np.pi * u / half_sup)
        vals[:, ci] = np.sinc(u) * np.where(np.abs(u) <= half_sup, wnd, 0.0)
    vals /= vals.sum(axis=1, keepdims=True)     # unity DC gain per delay
    mid = (_FARROW_LO + _FARROW_HI) / 2.0
    halfr = (_FARROW_HI - _FARROW_LO) / 2.0
    un = (d - mid) / halfr
    V = np.vander(un, _FARROW_DEG + 1)          # highest power first
    coef, *_ = np.linalg.lstsq(V, vals, rcond=None)
    err = np.abs(V @ coef - vals).max()
    assert err < 1e-3, f"farrow fit residual {err}"
    return coef.T.astype(np.float32), mid, halfr   # [TAPS, DEG+1]


def resample_windowed(y2: jax.Array, t: jax.Array) -> jax.Array:
    """Symbol-grid resampling with unbounded (slow) linear drift, fully
    vectorized: a tile-granular BARREL SHIFTER aligns the integer part
    of the delay (log2 masked static-slice stages over [T, cols] rows —
    no per-window dynamic slices, no per-symbol one-hot selects), then
    a narrow-band Farrow interpolator evaluates the taps as polynomials
    of the fractional delay (no 128-phase LUT / one-hot matmul).

    t: positions into y2, t[k] ~ 2k + drift with |d(t-2k)/dk| <=
    2*_MAX_SCO and total in-block drift < 2^(_SHIFT_BITS-1) samples.
    The per-tile constant integer shift is exact as long as the
    in-tile drift (2*_TILE_SYM*2*_MAX_SCO = 0.26 samples) stays inside
    the Farrow band's headroom.

    The selector this replaces (one-hot over 11 candidates x 8 taps +
    a [S, 128] one-hot tap matmul) was memory-bound; this formulation is
    ~10 masked passes + ~100 f32 FMAs per symbol.
    """
    S = t.shape[-1]
    TS = _TILE_SYM
    nt = -(-S // TS)
    Sp = nt * TS
    coef_np, mid, halfr = _farrow_coeffs()
    coef = jnp.asarray(coef_np)
    shift_bits = _shift_bits_for(S)
    bias = 1 << (shift_bits - 1)
    k = jnp.arange(Sp, dtype=t.dtype)
    tp = jnp.pad(t, (0, Sp - S), mode="edge") if Sp != S else t
    g = tp - 2 * k                                   # delay vs nominal
    # per-tile integer shift from the tile's center delay
    gt = g.reshape(nt, TS)
    r = jnp.round(0.5 * (gt[:, TS // 2 - 1] + gt[:, TS // 2])
                  ).astype(jnp.int32)                # [nt]
    rb = jnp.clip(r + bias, 0, 2 * bias - 1)
    d = gt - r[:, None].astype(t.dtype) + 4.0        # [nt, TS] in band
    u = (jnp.clip(d, _FARROW_LO, _FARROW_HI) - mid) / halfr
    # rows: tile ti needs y2[2*TS*ti + r_ti - 4 + c + 2j] for j<TS, c<10
    # = ypp[2*TS*ti + rb_ti + col], ypp = y2 padded left by bias+4.
    # Build [nt, 4*TS] overlapping rows by reshape (static), widen to
    # cover the shift range, then barrel-shift by rb per tile.
    width = 2 * TS + (2 * bias - 1) + _FARROW_TAPS
    nrows_needed = 2 * TS * (nt - 1) + width
    nb = -(-nrows_needed // (2 * TS)) + 1
    need_len = (nb + 1) * 2 * TS
    ypp = jnp.pad(y2, (bias + 4, 0))
    ypp = jnp.pad(ypp, (0, max(0, need_len - ypp.shape[0])))
    a = ypp[:need_len].reshape(nb + 1, 2 * TS)
    # rows[ti] = ypp[2*TS*ti : 2*TS*ti + width], assembled from ~3
    # row-shifted views of the reshape (static slices, no gathers)
    chunks = []
    covered = 0
    while covered < width:
        m = covered // (2 * TS)
        chunks.append(a[m:m + nt, :min(2 * TS, width - covered)])
        covered += 2 * TS
    rows = jnp.concatenate(chunks, axis=1)             # [nt, width]
    # barrel shift: drop rb columns from the left, log2 stages
    for b in reversed(range(shift_bits)):
        step = 1 << b
        bit = ((rb >> b) & 1).astype(bool)[:, None]
        w0 = rows.shape[1] - step
        rows = jnp.where(bit, rows[:, step:], rows[:, :w0])
    # rows now [nt, 2*TS + TAPS - 1 + ...]: column (2j + c) = the c-th
    # tap sample of symbol j.  Split the even/odd sample planes ONCE
    # (two stride-2 copies) so each tap reads a CONTIGUOUS [nt, TS]
    # slice instead of 10 strided passes over the full rows array
    rows_e = rows[:, 0::2]
    rows_o = rows[:, 1::2]
    out = jnp.zeros((nt, TS), y2.dtype)
    for ci in range(_FARROW_TAPS):
        tap = jnp.full((nt, TS), coef_np[ci, 0])
        for dg in range(1, _FARROW_DEG + 1):
            tap = tap * u + coef[ci, dg]
        plane = rows_e if ci % 2 == 0 else rows_o
        out = out + tap * jax.lax.slice(plane, (0, ci // 2),
                                        (nt, ci // 2 + TS))
    return out.reshape(Sp)[:S].astype(jnp.complex64)
