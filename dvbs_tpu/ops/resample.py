"""Arbitrary-rate ingest: rational polyphase resampler + channelizer.

The reference gets resampling for free from the SDR++ host: the plugin
pins its VFO to 2x symbolrate (main.cpp:129) and the host's channelizer
delivers exactly 2 samples/symbol, with runtime symbolrate/samplerate
coupling (main.cpp:217-243, module_dvbs2_demod.cpp:170-214). This module
is the device replacement for that host machinery:

- `rational_resample`: L/M polyphase resampler as L x T static
  strided-slice multiply-adds (gather-free, no single-channel
  convolution; a reshape puts the phase axis back in time
  order). The exact ratio 2*symbolrate/samplerate is approximated by a
  small fraction (denominator <= 64); the residual (<~0.1%) is ordinary
  sample-clock offset, absorbed by the block timing recovery
  (ops/frontend.recover_symbols tracks SCO like the reference's
  omegaRelLimit band, gardner.cpp).
- `StreamingResampler`: fixed-chunk streaming wrapper (static shapes ->
  one XLA program), exactly continuous across chunks (window overlap
  covers the filter support).
- `Channelizer`: splits one wideband capture into per-carrier 2 sps
  basebands (mix + resample per carrier) feeding the carrier bank
  (parallel/mesh.py) — the multi-VFO equivalent.

Math: upsample by L (zero-stuff), lowpass h (length L*T, cutoff at
min(input, output) Nyquist), downsample by M:
  y[k] = sum_t h[p_k + L*t] * x[n_k - t],
  p_k = (k*M) % L, n_k = floor(k*M / L).
The window form below substitutes s = T-1-t (reversed taps) and shifts
the read origin by T//2-1 so the net group delay is -1/(2L) input
samples (an imperceptible advance, absorbed by timing recovery).
"""
from __future__ import annotations

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np


def rate_fraction(samplerate: float, symbolrate: float,
                  max_den: int = 64) -> Fraction:
    """L/M with output rate = 2*symbolrate (approx), L/M*samplerate."""
    if symbolrate * 2 > samplerate:
        raise ValueError("samplerate must be >= 2*symbolrate")
    return Fraction(2.0 * symbolrate / samplerate).limit_denominator(max_den)


def default_taps_per_phase(L: int, M: int) -> int:
    """Length scales with the decimation ratio so the transition band
    stays inside [0.7, 1.3] x output Nyquist (the DVB signal occupies
    <=0.675 x output Nyquist at rolloff 0.35, 2 sps out)."""
    return max(16, int(np.ceil(13 * M / L)))


@functools.lru_cache()
def polyphase_taps(L: int, M: int, taps_per_phase: int) -> np.ndarray:
    """[L, T] time-reversed polyphase taps of a Kaiser-sinc lowpass.

    Prototype at the L-upsampled rate, length L*T, cutoff pi/max(L, M)
    (transition centered on the output Nyquist), Kaiser beta=7 (~60 dB
    image/alias rejection at the DVB band edge with the default T),
    gain L. taps[p, s] = h[p + L*(T-1-s)] so the window form is a plain
    forward MAC (see module docstring).
    """
    T = taps_per_phase
    n = L * T
    k = np.arange(n) - (n - 1) / 2.0
    cut = 1.0 / max(L, M)
    h = cut * np.sinc(cut * k) * np.kaiser(n, 7.0)
    h = h * (L / h.sum())
    rev = h.reshape(T, L).T[:, ::-1]          # [L, T]: h[p + L*(T-1-s)]
    return np.ascontiguousarray(rev).astype(np.float32)


def pad_amounts(L: int, M: int, taps_per_phase: int):
    """(left, right) input context samples the window form needs."""
    T = taps_per_phase
    return T // 2 - 1 + M // L + 1, T + M // L + 1


@functools.partial(jax.jit, static_argnames=("L", "M", "taps_per_phase", "K"))
def resample_window(xw: jax.Array, L: int, M: int,
                    taps_per_phase: int, K: int | None = None):
    """Window form: xw already carries `pad_amounts` context on both
    sides; output k interpolates input position k*M/L (position 0 =
    xw[left_pad]). Returns [K*L] samples (K outputs per phase lane).

    Output lane k0 + m*L shares polyphase phase (k0*M) % L and strides
    the input by M — each (k0, s) pair is one static strided slice
    scaled by a scalar tap; stack+reshape re-interleaves time order.
    L*T static vector MACs, no gathers.
    """
    taps = polyphase_taps(L, M, taps_per_phase)
    T = taps_per_phase
    lpad, rpad = pad_amounts(L, M, T)
    n_in = xw.shape[-1] - lpad - rpad
    if K is None:
        K = (n_in * L) // M // L
    org = lpad - (T // 2 - 1)     # read origin for input position 0
    lanes = []
    for k0 in range(L):
        p = (k0 * M) % L
        n0 = (k0 * M) // L
        acc = jnp.zeros(K, xw.dtype)
        for s in range(T):
            h = float(taps[p, s])
            if h != 0.0:
                i0 = org + n0 + s
                seg = jax.lax.slice(xw, (i0,), (i0 + (K - 1) * M + 1,), (M,))
                acc = acc + h * seg
        lanes.append(acc)
    return jnp.stack(lanes, axis=1).reshape(K * L)


def rational_resample(x: jax.Array, L: int, M: int,
                      taps_per_phase: int | None = None) -> jax.Array:
    """One-shot resample by L/M; y[k] = x(k*M/L) for k*M/L inside x
    (edge outputs within ~T/2 input samples of either end are filter
    transients). Output length len(x)*L//M (floored to the phase cycle).
    """
    if taps_per_phase is None:
        taps_per_phase = default_taps_per_phase(L, M)
    lpad, rpad = pad_amounts(L, M, taps_per_phase)
    xw = jnp.pad(x, (lpad, rpad))
    return resample_window(xw, L, M, taps_per_phase)


class StreamingResampler:
    """Exactly-continuous streaming wrapper over resample_window.

    Fixed-size input chunks (a multiple of M, so every chunk boundary
    falls on polyphase phase 0 -> one compiled program); the buffered
    overlap covers the filter support, so concatenated chunk outputs
    are bit-identical to the one-shot resample of the whole stream.
    """

    def __init__(self, samplerate: float, symbolrate: float,
                 chunk_hint: int = 1 << 16,
                 taps_per_phase: int | None = None):
        fr = rate_fraction(samplerate, symbolrate)
        self.L, self.M = fr.numerator, fr.denominator
        self.taps_per_phase = taps_per_phase if taps_per_phase is not None \
            else default_taps_per_phase(self.L, self.M)
        self.chunk = max(1, chunk_hint // self.M) * self.M
        self.actual_ratio = self.L / self.M
        self.residual_sco = 2.0 * symbolrate / samplerate / \
            self.actual_ratio - 1.0
        self._lpad, self._rpad = pad_amounts(self.L, self.M,
                                             self.taps_per_phase)
        # buffer holds [pos - lpad, ...) of the input stream; the first
        # feed pre-pads zeros, matching rational_resample's edge handling
        self._buf = np.zeros(self._lpad, np.complex64)

    @property
    def identity(self) -> bool:
        return self.L == self.M

    def feed(self, x: np.ndarray) -> np.ndarray:
        """Arbitrary-length input -> resampled output (2 sps nominal)."""
        if self.identity:
            return np.asarray(x, np.complex64)
        self._buf = np.concatenate([self._buf,
                                    np.asarray(x, np.complex64)])
        K = self.chunk * self.L // self.M // self.L
        outs = []
        while len(self._buf) >= self._lpad + self.chunk + self._rpad:
            win = self._buf[:self._lpad + self.chunk + self._rpad]
            y = resample_window(jnp.asarray(win), self.L, self.M,
                                self.taps_per_phase, K)
            outs.append(np.asarray(y))
            self._buf = self._buf[self.chunk:]
        return np.concatenate(outs) if outs else np.zeros(0, np.complex64)

    def get_state(self) -> dict:
        return dict(buf=self._buf.copy())

    def set_state(self, st: dict):
        self._buf = np.asarray(st["buf"], np.complex64).copy()


class Channelizer:
    """Multi-VFO bank: wideband capture -> per-carrier 2 sps basebands.

    carriers: list of (center_freq_hz, symbolrate_hz). Each carrier is
    mixed to baseband (open-loop NCO, phase-continuous across feeds) and
    resampled to 2x its symbolrate. The per-carrier outputs feed
    DVBS2Stream instances or the carrier bank (parallel/mesh.py).
    """

    def __init__(self, samplerate: float,
                 carriers: list[tuple[float, float]],
                 chunk_hint: int = 1 << 16):
        self.samplerate = samplerate
        self.carriers = list(carriers)
        self._n0 = 0
        self._rs = [StreamingResampler(samplerate, sym, chunk_hint)
                    for (_, sym) in carriers]

    _NCO_BLK = 256

    @functools.cached_property
    def _mix_fn(self):
        @functools.partial(jax.jit, static_argnames=("nb",))
        def mix(x, w, phi_blk, nb):
            # split-index NCO: per-block phases arrive precomputed in
            # float64 (reduced mod 2*pi on host), the in-block ramp
            # w*lo stays small (< 2*pi*blk) so float32 rounding never
            # exceeds ~1e-4 rad — a naive float32 w*t ramp drifts
            # ~0.01 rad by the end of a 65536-sample chunk and steps at
            # every chunk boundary
            lo = jnp.arange(Channelizer._NCO_BLK, dtype=jnp.float32)
            ph = phi_blk[:, :, None] + w[:, None, None] * lo[None, None, :]
            xb = x.reshape(1, nb, Channelizer._NCO_BLK)
            return (xb * jnp.exp(-1j * ph).astype(jnp.complex64)
                    ).reshape(w.shape[0], nb * Channelizer._NCO_BLK)
        return mix

    def feed(self, x: np.ndarray) -> list[np.ndarray]:
        """Wideband samples -> list of per-carrier 2 sps baseband arrays
        (lengths differ per carrier as resampler chunks fill)."""
        x = np.asarray(x, np.complex64)
        n = len(x)
        if n == 0:
            return [np.zeros(0, np.complex64) for _ in self._rs]
        blk = self._NCO_BLK
        nb = -(-n // blk)
        xpad = np.zeros(nb * blk, np.complex64)
        xpad[:n] = x
        w = np.array([2 * np.pi * f / self.samplerate
                      for (f, _) in self.carriers], np.float64)
        t0 = self._n0 + np.arange(nb, dtype=np.float64) * blk
        phi_blk = np.mod(w[:, None] * t0[None, :], 2 * np.pi)
        mixed = np.asarray(self._mix_fn(
            jnp.asarray(xpad), jnp.asarray(w.astype(np.float32)),
            jnp.asarray(phi_blk.astype(np.float32)), nb))[:, :n]
        self._n0 += n
        return [rs.feed(mixed[c]) for c, rs in enumerate(self._rs)]

    # checkpoint/resume: NCO sample counter + per-carrier resampler
    # buffers (the CLI's --state-file captures these alongside the
    # stream states so a restart is sample-exact)
    def get_state(self) -> dict:
        return dict(n0=self._n0, rs=[r.get_state() for r in self._rs])

    def set_state(self, st: dict):
        self._n0 = int(st["n0"])
        for r, s in zip(self._rs, st["rs"]):
            r.set_state(s)
