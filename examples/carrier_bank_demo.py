"""Multi-carrier bank demo: N independent DVB-S2 carriers demodulated
in ONE device program per block (the BASELINE 8-carrier configuration).

Run (CPU, 2 carriers, short frames):
    JAX_PLATFORMS=cpu python examples/carrier_bank_demo.py
Run (GPU, the bench shape — 8 carriers x 128 normal frames through the
int8 LDPC kernel):
    python examples/carrier_bank_demo.py --bench-shape
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from dvbs_tpu.spec import modcod
from dvbs_tpu.tx import dvbs2_mod, channel
from dvbs_tpu.parallel.mesh import build_carrier_bank, bank_block_symbols

BENCH = "--bench-shape" in sys.argv
C = 8 if BENCH else 2
MC, SHORT = 4, not BENCH

cfg = modcod.get_config(MC, short=SHORT)
block = bank_block_symbols(C, mc=MC, short=SHORT, frames_total=128)
n = 2 * block
print(f"{C} carriers, {cfg.constellation} {cfg.rate} {cfg.framesize}, "
      f"{block} symbols/carrier/block")

# a DISTINCT signal per carrier: different payload, SNR, CFO, delay
rng_sigs, sents = [], []
for c in range(C):
    pkts = dvbs2_mod.random_ts_packets(900 if not SHORT else 400,
                                       seed=50 + c)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=5.0 + 0.5 * c,
                       cfo=(0.002 + 0.002 * c) * np.pi,
                       delay_samples=0.13 * c, seed=60 + c)
    assert len(y) >= n, f"carrier {c}: {len(y)} < {n} samples"
    rng_sigs.append(y[:n])
    # kbch_bytes come back BB-descrambled from the device: compare plaintext
    from dvbs_tpu.spec import scrambling
    sents.append(scrambling.bb_scramble_bytes(bb).tobytes())


def to_cs8(y):
    rms = np.sqrt(np.mean(np.abs(y) ** 2))
    ri = np.stack([y.real, y.imag]) * (32.0 / rms)
    return np.clip(np.round(ri), -127, 127).astype(np.int8)


step, example = build_carrier_bank(
    C, mc=MC, short=SHORT, block_symbols=block)
samples = np.stack([to_cs8(s) for s in rng_sigs])
assert samples.shape == example.shape

out = {k: np.asarray(v) for k, v in step(samples).items()}
F = out["quality"].shape[1]
kb = out["kbch_bytes"].reshape(C, F, -1)
print(f"decoded {int(out['ldpc_ok'].sum())}/{C * F} frames "
      f"(LDPC trials max {int(out['trials'].max())}, "
      f"BCH clean: {not out['bch_bad'].any()})")
for c in range(C):
    ok = kb[c, 0].tobytes() in sents[c]
    print(f"  carrier {c}: quality {out['quality'][c].mean():.2f}, "
          f"first frame bytes in own TX stream: {ok}")
    assert ok
print("all carriers decoded their own streams")
