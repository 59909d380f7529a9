"""Bench-envelope regression coverage.

Round 4's only red gate lived in a parameter corner no CPU test touched:
32APSK 3/4 + pilots at the bench operating point (14.5 dB, cfo 0.018pi,
delay 0.85, cs4 ingest, normal frames).  The failure mechanism was the
flat-clamped tail of pilot_anchor_phases integrating the block-common
L&R frequency residual over the ~1.5k unanchored symbols after the last
pilot.  These tests pin:

1. the pilot-anchor phase track against a known residual-frequency ramp
   (fails on the pre-fix flat tail by >0.5 rad);
2. the barrel-shifter drift bound _shift_bits_for against every bench
   configuration's worst-case drift, computed independently;
3. the full corner end-to-end on CPU: 32APSK normal frames through the
   receiver at the bench's exact channel parameters with cs4 ingest.
"""
import numpy as np
import pytest

from dvbs_tpu.spec import modcod
from dvbs_tpu.ops import frontend, plphase


def test_pilot_anchor_tail_tracks_residual_freq():
    """A residual carrier of 5e-4 rad/symbol (worst block-common L&R
    miss) must be tracked through the WHOLE
    frame, including the unanchored tail after the last pilot block —
    the reference's per-symbol PLL free-runs its frequency state there
    (dvbs2_pll.cpp:34-86)."""
    import jax.numpy as jnp
    from dvbs_tpu.spec import scrambling
    from dvbs_tpu.ops.plphase import _header_syms

    cfg = modcod.get_config(24, short=False, pilots=True)  # 32APSK 3/4
    L = cfg.plframe_len
    F = 2
    rng = np.random.default_rng(0)
    f_res, phi0 = 5e-4, 0.3
    # known-symbol skeleton: real header + pilots, random payload
    frame = np.exp(1j * 2 * np.pi * rng.random(L)).astype(np.complex64)
    frame[:90] = _header_syms(cfg.pls_code)
    ph = scrambling.pl_scrambler_phasors()[:L - 90]
    pilot = (1 + 1j) / np.sqrt(2)
    for p in plphase.pilot_starts(cfg):
        frame[p:p + 36] = pilot * ph[p - 90:p - 90 + 36]
    n = np.arange(L)
    true_phase = phi0 + f_res * n
    frames = np.broadcast_to(frame * np.exp(1j * true_phase), (F, L))
    noisy = frames + (rng.normal(size=(F, L), scale=0.13) +
                      1j * rng.normal(size=(F, L), scale=0.13))  # ~14.5 dB
    fj = jnp.asarray(noisy.astype(np.complex64))
    theta0 = plphase.header_phase(fj, cfg)
    track = np.asarray(plphase.pilot_anchor_phases(fj, cfg, theta0))
    err = track - true_phase[None, :]
    err = err - np.round(err.mean() / (2 * np.pi)) * 2 * np.pi
    # payload region only (skip the 90-symbol header ramp-in)
    assert np.abs(err[:, 90:]).max() < 0.08, np.abs(err[:, 90:]).max()
    # and specifically the post-last-pilot tail (the round-4 bug site)
    last = int(plphase.pilot_starts(cfg)[-1]) + 36
    assert np.abs(err[:, last:]).max() < 0.08, np.abs(err[:, last:]).max()


def test_shift_bits_cover_bench_drift():
    """The barrel drift bound must cover every bench config's worst-case
    drift with margin: delay up to 0.95 samples, sco 10 ppm (spec bound
    _MAX_SCO = 250 ppm), tau carry re-centering |tau| <= 1.5 symbols,
    at each family's bank block size (bench.py uses bank_block_symbols
    for 8 carriers)."""
    from dvbs_tpu.parallel.mesh import bank_block_symbols

    configs = [(4, False), (14, True), (18, True), (24, True)]
    for mc, pilots in configs:
        S = bank_block_symbols(8, mc=mc, short=False, pilots=pilots)
        bits = frontend._shift_bits_for(S)
        half_range = 1 << (bits - 1)
        # independent worst-case drift (samples): carried tau bound
        # (+-1.5 symbols = 3 samples), initial fractional delay < 1,
        # SCO accumulation over the whole block at the SPEC bound
        worst = 3.0 + 1.0 + 2 * S * frontend._MAX_SCO
        assert half_range >= worst + 4, (mc, S, bits, worst)
        # DVB-S bank block too (2^18 samples = 2^17 symbols)
        bits_s = frontend._shift_bits_for(1 << 17)
        assert (1 << (bits_s - 1)) >= 3.0 + 1.0 + 2 * (1 << 17) * \
            frontend._MAX_SCO + 4


@pytest.mark.parametrize("cfo_pi,delay", [
    (0.018, 0.85),    # the exact round-4 red-gate corner (carrier 6)
    (0.020, 0.95),    # bench carrier 7 (max cfo + max delay)
])
def test_32apsk_bench_corner_cpu(cfo_pi, delay):
    """32APSK 3/4 + pilots, normal frames, at the bench operating point
    (14.5 dB, cs4 ingest, sco 10 ppm) — single carrier, 2 frames, CPU.
    Pre-fix, the flat-tail phase clamp left ~0.6 rad of error at frame
    end at cfo 0.018pi and LDPC failed at 12 trials (the round-4 red
    bench gate)."""
    import jax.numpy as jnp
    from dvbs_tpu.tx import dvbs2_mod, channel
    from dvbs_tpu.models.dvbs2 import DVBS2Receiver

    cfg = modcod.get_config(24, short=False, pilots=True)
    L = cfg.plframe_len
    F = 2
    block = 2 * 256 + 90 + (F + 1) * L + 64
    pkts = dvbs2_mod.random_ts_packets(6 * (cfg.kbch // 8 // 188), seed=128)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=14.5, cfo=cfo_pi * np.pi,
                       delay_samples=delay, sco_ppm=10.0, seed=129)
    n = 2 * block
    assert len(y) >= n, (len(y), n)
    packed = frontend.pack_cs4(y[:n])
    ri = np.asarray(frontend.unpack_cs4(jnp.asarray(packed[None]))[0])
    samples = (ri[0] + 1j * ri[1]).astype(np.complex64)
    rx = DVBS2Receiver(mc=24, short=False, pilots=True,
                       block_symbols=block, max_ldpc_trials=12)
    res = rx.process_symbols_block(samples)
    assert res.frame_ok.all(), (res.ldpc_trials, res.bch_corrections)
    assert (res.detected_pls == cfg.pls_code).all()
