"""Carrier-bank (single-device multi-carrier) tests on CPU.

The bank is the BASELINE north-star configuration (bench.py runs it at
8 carriers x 128 frames on the GPU); here a 2-carrier short-frame bank
with DISTINCT per-carrier signals checks carrier independence, and the
cs4 packed-4-bit ingest path is validated against cs8.
"""
import numpy as np
import pytest

from dvbs_tpu.spec import modcod
from dvbs_tpu.tx import dvbs2_mod, channel
from dvbs_tpu.ops import frontend
from dvbs_tpu.parallel.mesh import build_carrier_bank, bank_block_symbols

MC, SHORT = 4, True
CARRIERS = 2


def _carrier_signal(seed: int, n: int, cfo: float) -> np.ndarray:
    cfg = modcod.get_config(MC, short=SHORT)
    pkts = dvbs2_mod.random_ts_packets(300, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=6.0, cfo=cfo, delay_samples=0.3,
                       seed=seed)
    assert len(y) >= n
    return y[:n]


@pytest.fixture(scope="module")
def bank_io():
    block = bank_block_symbols(CARRIERS, mc=MC, short=SHORT,
                               frames_total=4)
    n = 2 * block
    sigs = [_carrier_signal(7, n, 0.004 * np.pi),
            _carrier_signal(8, n, -0.009 * np.pi)]
    return block, n, sigs


def _to_cs8(y: np.ndarray) -> np.ndarray:
    rms = np.sqrt(np.mean(np.abs(y) ** 2))
    ri = np.stack([y.real, y.imag]) * (32.0 / rms)
    return np.clip(np.round(ri), -127, 127).astype(np.int8)


def test_bank_distinct_carriers_cs8(bank_io):
    block, n, sigs = bank_io
    step, example = build_carrier_bank(CARRIERS, mc=MC, short=SHORT,
                                       block_symbols=block)
    samples = np.stack([_to_cs8(s) for s in sigs])
    assert samples.shape == example.shape and samples.dtype == example.dtype
    out = {k: np.asarray(v) for k, v in step(samples).items()}
    F = out["quality"].shape[1]
    assert out["ldpc_ok"].all()
    assert not out["bch_bad"].any()
    # per-carrier frames decode to DIFFERENT payloads (carrier
    # independence: a broadcast bug would make them identical)
    kb = out["kbch_bytes"].reshape(CARRIERS, F, -1)
    assert not np.array_equal(kb[0], kb[1])
    # and each carrier's bytes appear in its own TX BBFRAMEs
    # (kbch_bytes come back BB-descrambled from the device, so compare
    # against the plaintext frames)
    from dvbs_tpu.spec import scrambling
    cfg = modcod.get_config(MC, short=SHORT)
    for c, seed in enumerate((7, 8)):
        pkts = dvbs2_mod.random_ts_packets(300, seed=seed)
        sent = scrambling.bb_scramble_bytes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg)).tobytes()
        got = kb[c].tobytes()
        assert got[:cfg.kbch // 8] in sent


def test_bank_cs4_ingest_matches_cs8(bank_io):
    block, n, sigs = bank_io
    step, example = build_carrier_bank(CARRIERS, mc=MC, short=SHORT,
                                       block_symbols=block,
                                       ingest="cs4")
    packed = np.stack([frontend.pack_cs4(s) for s in sigs])
    assert packed.shape == example.shape and packed.dtype == example.dtype
    out = {k: np.asarray(v) for k, v in step(packed).items()}
    assert out["ldpc_ok"].all()
    assert not out["bch_bad"].any()
    # identical decoded bytes as the cs8 run (4-bit quantization costs
    # no correctness at 6 dB)
    step8, _ = build_carrier_bank(CARRIERS, mc=MC, short=SHORT,
                                  block_symbols=block)
    out8 = {k: np.asarray(v)
            for k, v in step8(np.stack([_to_cs8(s) for s in sigs])).items()}
    assert np.array_equal(out["kbch_bytes"], out8["kbch_bytes"])


def test_bank_pallas_fec_full_width():
    """The GPU route's wiring (quantize -> per-frame kernel -> BCH
    syndromes + packing -> real trials), end to end on CPU via
    interpret mode: 2 carriers x 64 short frames with DISTINCT
    signals and different SNRs (per-frame LLR quantization must keep
    the weak carrier decodable next to a strong one)."""
    block = bank_block_symbols(CARRIERS, mc=MC, short=SHORT,
                               frames_total=128)
    n = 2 * block
    cfg = modcod.get_config(MC, short=SHORT)
    need = int(np.ceil(64 * cfg.kbch / 8 / 188 / 8)) * 8 + 16
    sigs, sents = [], []
    for seed, snr in ((21, 5.0), (22, 12.0)):
        pkts = dvbs2_mod.random_ts_packets(need, seed=seed)
        bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
        tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
        x = channel.shape(tx, sps=2)
        y = channel.impair(x, snr_db=snr, cfo=0.004 * np.pi,
                           delay_samples=0.3, seed=seed)
        assert len(y) >= n
        sigs.append(y[:n])
        from dvbs_tpu.spec import scrambling
        sents.append(scrambling.bb_scramble_bytes(bb).tobytes())
    step, _ = build_carrier_bank(CARRIERS, mc=MC, short=SHORT,
                                 block_symbols=block, interpret=True)
    samples = np.stack([_to_cs8(s) for s in sigs])
    out = {k: np.asarray(v) for k, v in step(samples).items()}
    assert out["ldpc_ok"].all()
    assert not out["bch_bad"].any()
    tr = out["trials"]
    assert (tr >= 1).all() and (tr < 12).all()
    F = out["quality"].shape[1]
    kb = out["kbch_bytes"].reshape(CARRIERS, F, -1)
    for c in range(CARRIERS):
        assert kb[c, 0].tobytes() in sents[c]


def test_pack_unpack_cs4_roundtrip():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    y = (rng.normal(size=257) + 1j * rng.normal(size=257)) \
        .astype(np.complex64)
    p = frontend.pack_cs4(y, scale=2.5)
    assert p.dtype == np.uint8 and p.shape == (257,)
    ri = np.asarray(frontend.unpack_cs4(jnp.asarray(p)))
    assert ri.shape == (2, 257) and ri.dtype == np.int8
    assert ri.min() >= -7 and ri.max() <= 7
    # values match the host-side quantizer exactly
    rms = np.sqrt(np.mean(np.abs(y) ** 2))
    q = np.clip(np.round(np.stack([y.real, y.imag]) * (2.5 / rms)), -7, 7)
    assert np.array_equal(ri, q.astype(np.int8))


def test_bank_8psk_pilots():
    """Bank coverage beyond the bench config: 8PSK 3/5 short frames
    WITH pilots (pilot-anchored phase path) through build_carrier_bank —
    the reference supports pilots on every MODCOD (modcod_to_cfg.cpp)."""
    mc8 = 12                       # 8PSK 3/5
    block = bank_block_symbols(CARRIERS, mc=mc8, short=True, pilots=True,
                               frames_total=4)
    n = 2 * block
    cfg = modcod.get_config(mc8, short=True, pilots=True)
    sigs, sents = [], []
    for seed, cfo in ((31, 0.003 * np.pi), (32, -0.006 * np.pi)):
        pkts = dvbs2_mod.random_ts_packets(40, seed=seed)
        bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
        tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
        x = channel.shape(tx, sps=2)
        y = channel.impair(x, snr_db=12.0, cfo=cfo, delay_samples=0.2,
                           seed=seed)
        assert len(y) >= n
        sigs.append(y[:n])
        from dvbs_tpu.spec import scrambling
        sents.append(scrambling.bb_scramble_bytes(bb).tobytes())
    step, _ = build_carrier_bank(CARRIERS, mc=mc8, short=True, pilots=True,
                                 block_symbols=block)
    samples = np.stack([_to_cs8(s) for s in sigs])
    out = {k: np.asarray(v) for k, v in step(samples).items()}
    assert out["ldpc_ok"].all()
    assert not out["bch_bad"].any()
    F = out["quality"].shape[1]
    kb = out["kbch_bytes"].reshape(CARRIERS, F, -1)
    for c in range(CARRIERS):
        assert kb[c, 0].tobytes() in sents[c], f"carrier {c}"


def test_bank_pallas_any_carrier_count():
    """The kernel route with a frame total of 6 (3 carriers x 2 frames):
    one program per frame, so any count decodes (regression: the CLI
    --carrier path crashed for carrier counts not dividing 128)."""
    block = bank_block_symbols(3, mc=MC, short=SHORT, frames_total=6)
    step, example = build_carrier_bank(3, mc=MC, short=SHORT,
                                       block_symbols=block,
                                       interpret=True)
    sigs = [_carrier_signal(40 + i, 2 * block, 0.003 * np.pi * (i + 1))
            for i in range(3)]
    out = {k: np.asarray(v)
           for k, v in step(np.stack([_to_cs8(s) for s in sigs])).items()}
    assert out["ldpc_ok"].all() and not out["bch_bad"].any()
