"""Dummy PLFRAME tolerance (beyond-reference hardening).

Real transponders insert dummy PLFRAMEs (MODCOD 0: PLS-0 header + 36
slots of scrambled unmodulated carrier) between data frames when the
mux is idle.  The data-field byte stream is CONTIGUOUS across dummies,
so the receiver must ride through them without marking parser gaps
(the reference free-runs through them per-sample and never notices,
module_dvbs2_demod.cpp:318-368; a block receiver has to handle the
frame-grid disruption explicitly)."""
import numpy as np
import pytest

from dvbs_tpu.spec import modcod
from dvbs_tpu.tx import dvbs2_mod, channel
from dvbs_tpu.models.driver import DVBS2Stream


def _contiguous(got: bytes, sent: np.ndarray, label: str) -> int:
    g = np.frombuffer(got, np.uint8)
    assert len(g) >= 188 and len(g) % 188 == 0, \
        f"{label}: no/ragged TS ({len(g)} B)"
    gp = g.reshape(-1, 188)
    sp = sent.reshape(-1, 188)
    i0 = sent.tobytes().find(gp[0].tobytes())
    assert i0 >= 0 and i0 % 188 == 0, f"{label}: first packet not in TX"
    k0 = i0 // 188
    assert np.array_equal(gp, sp[k0:k0 + len(gp)]), \
        f"{label}: not a contiguous run"
    return len(gp)


@pytest.mark.parametrize("every,n_dummies", [(3, 1), (2, 2)])
def test_stream_rides_through_dummies(every, n_dummies):
    cfg = modcod.get_config(4, short=True)      # QPSK 1/2 short
    pkts = dvbs2_mod.random_ts_packets(260, seed=5)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    frames = dvbs2_mod.bbframes_to_plframes(bb, cfg)
    tx = dvbs2_mod.interleave_dummies(frames, every=every,
                                      n_dummies=n_dummies)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=7.0, cfo=0.008 * np.pi,
                       delay_samples=0.45, sco_ppm=10.0, seed=6)

    st = DVBS2Stream(mc=4, short=True, block_symbols=1 << 15,
                     dummy_aware=True)
    out = bytearray()
    chunk = 1 << 15
    for lo in range(0, len(y), chunk):
        out.extend(st.feed(y[lo:lo + chunk]))
    npk = _contiguous(bytes(out), pkts, f"dummies every {every}")
    # nearly all packets recovered in ONE contiguous run — no packet
    # lost at any dummy boundary (the stream has no flush: the head
    # margin and up to ~2 blocks of FIFO tail trim the ends)
    total = len(pkts) // 188
    assert npk >= int(0.85 * total), (npk, total)


def test_dummy_slots_detected_not_gapped():
    """Dummy slots must be recognized (PLS index 0, confident) and the
    modcod vote must ignore them."""
    cfg = modcod.get_config(4, short=True)
    pkts = dvbs2_mod.random_ts_packets(120, seed=7)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    frames = dvbs2_mod.bbframes_to_plframes(bb, cfg)
    tx = dvbs2_mod.interleave_dummies(frames, every=2)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=9.0, cfo=0.004 * np.pi,
                       delay_samples=0.3, sco_ppm=5.0, seed=8)
    st = DVBS2Stream(mc=4, short=True, block_symbols=1 << 15,
                     auto_modcod=True, dummy_aware=True)
    for lo in range(0, len(y), 1 << 15):
        st.feed(y[lo:lo + (1 << 15)])
    # the vote buffer holds only data-frame PLS codes
    assert all(v >> 2 != 0 for v in st._vote)
    assert st.cfg.pls_code == cfg.pls_code      # no spurious switch
