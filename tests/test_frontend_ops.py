"""Equivalence tests for the matmul formulations of the front-end ops
(plsync.correlate, frontend.fir_filter, frontend.resample_half_grid)
against brute-force/naive golden implementations — these ops were
rewritten from shift-and-add / one-hot-select forms for throughput and
must stay numerically faithful."""
import numpy as np
import jax
import jax.numpy as jnp

from dvbs_tpu.ops import frontend, plsync
from dvbs_tpu.spec import plheader
from dvbs_tpu.tx.channel import rrc_taps


def test_correlate_matches_shift_and_add():
    rng = np.random.default_rng(0)
    sof_t, pls_t = plheader.header_diff_templates()
    for n in (97, 512, 601, 2048):
        z = (rng.normal(size=n) + 1j * rng.normal(size=n)
             ).astype(np.complex64)
        score, c = jax.jit(plsync.correlate)(jnp.asarray(z))
        d = np.concatenate([[0], z[1:] * np.conj(z[:-1])]
                           ).astype(np.complex128)
        nout = n - 89

        def corr(t):
            acc = np.zeros(nout, np.complex128)
            for k in np.nonzero(t)[0]:
                acc += t[k] * d[k:k + nout]
            return acc

        c0 = corr(sof_t) + corr(pls_t)
        c1 = corr(sof_t) - corr(pls_t)
        # where |c0| ~ |c1| the pick can flip on bf16 rounding; both
        # are valid detection statistics, so compare against either
        err = np.minimum(np.abs(np.asarray(c) - c0 / 57.0),
                         np.abs(np.asarray(c) - c1 / 57.0))
        assert c.shape == (nout,)
        assert err.max() < 0.02
        sg = np.maximum(np.abs(c0), np.abs(c1)) / 57.0
        assert np.abs(np.asarray(score) - sg).max() < 0.02


def test_fir_filter_mxu_matches_shift_and_add():
    rng = np.random.default_rng(1)

    def old_fir(x, taps):
        taps = np.asarray(taps, np.float32)
        K = len(taps)
        n = x.shape[-1]
        half = K // 2
        xp = jnp.pad(x, (half, K - 1 - half))
        acc = jnp.zeros(n, x.dtype)
        for j, h in enumerate(taps.tolist()):
            if h != 0.0:
                acc = acc + h * xp[j:j + n]
        return acc.astype(jnp.complex64)

    for n, K in ((5000, 65), (4096, 65), (1 << 14, 47), (777, 65)):
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)
             ).astype(np.complex64)
        taps = rrc_taps(K, 0.35, 2.0)
        exact = np.asarray(jax.jit(
            lambda a, t=taps: frontend.fir_filter(a, t, bf16=False)
        )(jnp.asarray(x)))
        old = np.asarray(jax.jit(
            lambda a, t=taps: old_fir(a, t))(jnp.asarray(x)))
        assert np.abs(exact - old).max() < 2e-5
        # default bf16 path: 8-bit-mantissa products, f32 accumulation —
        # per-sample error must stay ~40 dB below the unit-power signal
        # (the operating channel noise floor is at -5..-10 dB)
        fast = np.asarray(jax.jit(
            lambda a, t=taps: frontend.fir_filter(a, t))(jnp.asarray(x)))
        assert np.abs(fast - old).max() < 0.05
        assert np.sqrt(np.mean(np.abs(fast - old) ** 2)) < 0.02

    # the timing-recovery interpolators also ride the bf16 matmul path
    # (K=24 half-sample kernel feeding Oerder&Meyr, K=47 halfband):
    # same error bound applies on those tap sets
    x = (rng.normal(size=1 << 14) + 1j * rng.normal(size=1 << 14)
         ).astype(np.complex64)
    for taps in (frontend._mid_taps(), frontend._halfband_taps()):
        exact = np.asarray(jax.jit(
            lambda a, t=taps: frontend.fir_filter(a, t, bf16=False)
        )(jnp.asarray(x)))
        fast = np.asarray(jax.jit(
            lambda a, t=taps: frontend.fir_filter(a, t))(jnp.asarray(x)))
        assert np.abs(fast - exact).max() < 0.05
        assert np.sqrt(np.mean(np.abs(fast - exact) ** 2)) < 0.02


def test_resample_half_grid_matches_brute_force():
    rng = np.random.default_rng(2)
    S = 384
    SP = frontend._RESAMPLE_SPAN
    y = (rng.normal(size=2 * S + 6 * SP + 32) +
         1j * rng.normal(size=2 * S + 6 * SP + 32)).astype(np.complex64)
    drift = SP + 2 * SP * np.linspace(0.1, 0.9, S) + \
        0.3 * np.sin(np.arange(S) * 0.01)
    t = (2 * np.arange(S) + drift).astype(np.float32)
    out = np.asarray(frontend.resample_half_grid(
        jnp.asarray(y), jnp.asarray(t), S))
    bank = frontend.interp_bank(128, 8)
    g = np.zeros(S, np.complex64)
    for k in range(S):
        i0 = int(np.floor(t[k]))
        mu = t[k] - i0
        ph = min(int(round(mu * 128)), 127)
        idx = i0 - 3 + np.arange(8)
        g[k] = (y[idx] * bank[ph]).sum()
    assert np.abs(out - g).max() < 2e-5


def test_farrow_resampler_matches_polyphase_bank():
    """The Farrow per-tap polynomials must reproduce the 128-phase
    windowed-sinc bank (resample_at) to well under a percent rms on a
    band-limited signal with SCO drift."""
    import jax.numpy as jnp
    from dvbs_tpu.tx import channel
    rng = np.random.default_rng(3)
    n = 1 << 14
    sym = ((rng.integers(0, 2, n // 2) * 2 - 1) +
           1j * (rng.integers(0, 2, n // 2) * 2 - 1)).astype(np.complex64)
    y = channel.shape(sym, sps=2)[:n]
    S = n // 2
    k = np.arange(S)
    for tau, sco in ((0.3, 180e-6), (-0.45, -240e-6), (0.05, 0.0)):
        t = np.clip(2.0 * k + 2 * tau + 2 * sco * k, 0, n - 1.0
                    ).astype(np.float32)
        ref = np.asarray(frontend.resample_at(jnp.asarray(y),
                                              jnp.asarray(t)))
        got = np.asarray(frontend.resample_windowed(jnp.asarray(y),
                                                    jnp.asarray(t)))
        m = slice(64, S - 64)
        scale = np.abs(ref[m]).mean()
        err = np.abs(got[m] - ref[m]) / scale
        assert err.max() < 0.02 and err.mean() < 0.005, (tau, sco, err.max())
