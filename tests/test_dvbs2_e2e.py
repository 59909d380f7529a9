"""End-to-end DVB-S2 receiver tests: TX oracle -> impaired channel -> RX."""
import numpy as np
import pytest

from dvbs_tpu.spec import modcod, scrambling, bbheader
from dvbs_tpu.tx import dvbs2_mod, channel
from dvbs_tpu.models.dvbs2 import DVBS2Receiver


def _run_chain(mc=4, short=True, pilots=False, snr_db=6.0, cfo=0.0,
               phase=0.5, delay=0.7, sco_ppm=20.0, n_pkts=200, seed=0,
               block_symbols=1 << 15, **rx_kw):
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx_syms = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx_syms, sps=2)
    y = channel.impair(x, snr_db=snr_db, cfo=cfo, phase=phase,
                       delay_samples=delay, sco_ppm=sco_ppm, seed=seed + 1)
    rx = DVBS2Receiver(mc=mc, short=short, pilots=pilots,
                       block_symbols=block_symbols, **rx_kw)
    n = 2 * block_symbols
    assert len(y) >= n, f"need {n} samples, have {len(y)}"
    res = rx.process_symbols_block(y[:n])
    # expected plaintext bbframes
    expect = scrambling.bb_scramble_bytes(bb)
    return res, expect, cfg


def _count_matches(res, expect):
    got = {f.tobytes() for f in res.bbframes}
    return sum(1 for e in expect if e.tobytes() in got)


def test_e2e_qpsk12_short_clean_channel():
    res, expect, cfg = _run_chain(snr_db=20.0, cfo=0.0, sco_ppm=0.0,
                                  delay=0.0, phase=0.0)
    assert res.frame_ok.all()
    assert _count_matches(res, expect) >= len(res.bbframes) - 1
    assert res.sync_quality.min() > 0.6
    # headers parse
    hdr = bbheader.BBHeader.parse(res.bbframes[0])
    assert hdr.ts_gs == bbheader.TS_GS_TRANSPORT
    assert (res.detected_pls == cfg.pls_code).all()


def test_e2e_qpsk12_short_impaired():
    # 6 dB Es/N0 (threshold ~1 dB), CFO 2% of symbol rate, phase offset,
    # fractional delay, 20 ppm clock offset
    res, expect, cfg = _run_chain(snr_db=6.0, cfo=0.02 * np.pi, phase=1.1,
                                  delay=0.6, sco_ppm=20.0)
    assert res.frame_ok.all(), (res.ldpc_trials, res.bch_corrections)
    assert _count_matches(res, expect) >= len(res.bbframes) - 1


def test_e2e_qpsk12_short_pallas_fec_path():
    """DVBS2Receiver on the GPU route: the stream/CLI path through the
    int8 per-frame kernel (this block's few frames), interpret mode on
    CPU. Must produce the same accepted frames as the xla path at the
    same operating point."""
    res, expect, cfg = _run_chain(snr_db=6.0, cfo=0.015 * np.pi, phase=0.8,
                                  delay=0.4, sco_ppm=10.0, interpret=True,
                                  max_ldpc_trials=12)
    assert res.frame_ok.all(), (res.ldpc_trials, res.bch_corrections)
    assert _count_matches(res, expect) >= len(res.bbframes) - 1
    assert (res.ldpc_trials >= 1).all() and (res.ldpc_trials < 12).all()


def test_e2e_qpsk12_short_near_threshold():
    res, expect, cfg = _run_chain(snr_db=2.5, cfo=0.01 * np.pi, phase=0.3,
                                  delay=0.3, sco_ppm=10.0)
    # at 2.5 dB every frame should still decode (threshold ~1 dB)
    assert res.frame_ok.all(), (res.ldpc_trials, res.bch_corrections)
    assert _count_matches(res, expect) >= len(res.bbframes) - 1


def test_e2e_normal_frames():
    res, expect, cfg = _run_chain(mc=4, short=False, snr_db=6.0,
                                  cfo=0.005 * np.pi, delay=0.4, sco_ppm=5.0,
                                  n_pkts=1600, block_symbols=1 << 17)
    assert res.frame_ok.all(), (res.ldpc_trials, res.bch_corrections)
    assert _count_matches(res, expect) >= len(res.bbframes) - 1


def test_e2e_with_pilots():
    res, expect, cfg = _run_chain(mc=4, short=True, pilots=True, snr_db=6.0,
                                  cfo=0.01 * np.pi, delay=0.2, sco_ppm=10.0)
    assert res.frame_ok.all(), (res.ldpc_trials, res.bch_corrections)
    assert _count_matches(res, expect) >= len(res.bbframes) - 1
    assert (res.detected_pls == cfg.pls_code).all()
