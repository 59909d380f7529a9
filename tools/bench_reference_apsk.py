#!/usr/bin/env python3
"""Reference-implementation denominators for the non-QPSK configs.

Extends REFBENCH.json (tools/bench_reference.py) with measured LDPC
throughput and derived per-core Msamp/s bounds for the higher-order
configurations bench.py runs: 8PSK 3/4 + pilots, 16APSK 2/3 + pilots,
32APSK 3/4 + pilots — so the device rates have honest reference
denominators per constellation family.

LLRs are produced the way the reference itself would see them: our TX
oracle modulates real BBFRAMEs (dvbs_tpu.tx, interop-validated), AWGN
at each config's operating Es/N0 is added, the REFERENCE demapper
(constellation.cpp demod_soft_calc via the refshim) computes int8
LLRs with the true noise power, and the REFERENCE deinterleaver
restores codeword order.  A clean-symbol round trip must decode with
0 extra trials, which pins every ordering/scale convention before
timing.  Methodology matches bench_reference.derive(): the derived
bound counts LDPC (all-16-lane best case) + BCH only — front end and
demap excluded, strictly favoring the reference.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import ref_oracle as R  # noqa: E402

# (label, modcod, operating Es/N0 dB — the SNRs bench.py's
# bench_hiord_bank gates use: 9.5, 11 and 14.5 dB)
CONFIGS = [
    ("8psk_34_pilots", 14, 9.5),
    ("16apsk_23_pilots", 18, 11.0),
    ("32apsk_34_pilots", 24, 14.5),
]


def config_llrs(mc: int, snr_db: float | None, n_frames: int,
                seed: int = 0) -> np.ndarray:
    """[n_frames, N] int8 codeword LLRs via TX oracle + reference
    demap/deinterleave at Es/N0 = snr_db (None = clean)."""
    from dvbs_tpu.spec import modcod, scrambling
    from dvbs_tpu.tx import dvbs2_mod
    cfg = modcod.get_config(mc, short=False, pilots=False)
    pkts = dvbs2_mod.random_ts_packets(
        (cfg.kbch // 8 // 188 + 2) * (n_frames + 1), seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    frames = dvbs2_mod.bbframes_to_plframes(bb, cfg)[:n_frames]
    assert len(frames) == n_frames
    rng = np.random.default_rng(seed + 1)
    out = []
    for f in frames:
        # the TX PL-scrambles everything after the header; the reference
        # demaps post-descrambling symbols (dvbs2_pll.cpp output), so
        # descramble here (noise is rotation-invariant)
        payload = scrambling.pl_descramble(f[90:])
        if snr_db is None:
            y = payload
        else:
            sigma2 = 10 ** (-snr_db / 10)
            y = payload + np.sqrt(sigma2 / 2) * (
                rng.standard_normal(len(payload)) +
                1j * rng.standard_normal(len(payload)))
        # npwr = 1.0: the reference pipeline demaps via demod_soft_lut,
        # which uses demod_soft_calc's default npwr of 1.0
        # (dvbs2_bb_to_soft.cpp:15, constellation.h:55,65) — small npwr
        # also overflows the int8 cast (measured: all signs flip)
        llr_sym = R.constellation_soft_demod(
            y.astype(np.complex64), cfg.constellation,
            cfg.g1 or 0.0, cfg.g2 or 0.0, 1.0)
        llr = R.s2_deinterleave(llr_sym.reshape(-1), cfg.constellation,
                                False, cfg.rate)
        out.append(llr)
    return np.stack(out)


def main() -> int:
    from dvbs_tpu.spec import modcod
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "REFBENCH.json")
    results = json.load(open(path))
    W = R.ldpc_simd_width()
    bch8 = results["bch_normal_12"]["sec_per_frame_8err"]
    for label, mc, snr in CONFIGS:
        cfg_np = modcod.get_config(mc, short=False, pilots=False)
        # ordering/scale validation: clean symbols -> already a codeword
        clean = config_llrs(mc, None, 1, seed=17)
        _, trials = R.ldpc_decode(clean[0], False, cfg_np.rate,
                                  max_trials=16)
        assert 0 <= trials <= 1, (label, trials)   # -1 = decode FAILED
        llrs = config_llrs(mc, snr, W, seed=11)
        reps = 10
        t1, tr1 = R.ldpc_bench(llrs, False, cfg_np.rate, blocks=1,
                               reps=reps)
        tw, trw = R.ldpc_bench(llrs, False, cfg_np.rate, blocks=W,
                               reps=reps)
        results[f"ldpc_{label.split('_')[0]}_{cfg_np.rate.replace('/', '')}"
                f"_{snr}db"] = {
            "as_shipped_frames_per_s": round(1.0 / t1, 1),
            "all16_frames_per_s": round(W / tw, 1),
            "all16_trials": trw,
            "sec_per_call_all16": tw,
        }
        # derived per-core bound at the PILOTED frame length the device
        # numbers use (samples/frame = 2 * plframe_len)
        cfg_p = modcod.get_config(mc, short=False, pilots=True)
        spf = 2 * cfg_p.plframe_len
        t_frame = tw / W + bch8
        results[f"derived_{label}_msamples_per_s_per_core"] = round(
            spf / t_frame / 1e6, 3)
        print(f"{label}: ldpc 16-lane {W/tw:8.1f} fr/s ({trw:.1f} trials)"
              f" -> derived/core {spf / t_frame / 1e6:7.3f} Msamp/s",
              flush=True)
    results["host"]["apsk_measured_utc"] = time.strftime(
        "%Y-%m-%d %H:%M:%S", time.gmtime())
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"updated {os.path.normpath(path)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
