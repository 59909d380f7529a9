"""Bank-level auto-MODCOD (models/bank_stream.DVBS2BankStream).

The reference applies a 50-frame unanimous PLS vote per instance
(main.cpp:383-408); the bank lifts that to its shared device program:
when EVERY carrier's confidence-gated vote settles on the same new
MODCOD, the bank rebuilds once and streaming continues from the
buffered samples — misconfigured-period frames fail the BCH-strict
gate (no garbage TS), post-switch frames decode byte-exact.
"""
import numpy as np

from dvbs_tpu.spec import modcod
from dvbs_tpu.tx import dvbs2_mod, channel
from dvbs_tpu.models.bank_stream import DVBS2BankStream
from dvbs_tpu.parallel.mesh import bank_block_symbols

SHORT = True
C = 2


def _carrier(mc, seed, n_pkts, cfo, delay, snr=8.0):
    cfg = modcod.get_config(mc, short=SHORT)
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=snr, cfo=cfo, delay_samples=delay,
                       sco_ppm=10.0, seed=seed + 1)
    return y, pkts.reshape(-1, 188)


def _contiguous_match(got: bytes, sent: np.ndarray) -> int:
    g = np.frombuffer(got, np.uint8)
    assert len(g) % 188 == 0
    gp = g.reshape(-1, 188)
    if len(gp) == 0:
        return 0
    sb = sent.tobytes()
    i0 = sb.find(gp[0].tobytes())
    assert i0 >= 0 and i0 % 188 == 0
    assert np.array_equal(gp, sent[i0 // 188:i0 // 188 + len(gp)])
    return len(gp)


def test_bank_auto_modcod_switch():
    # bank starts configured for QPSK 1/2 (mc=4); the carriers actually
    # transmit QPSK 2/3 (mc=6) — same QPSK short frame geometry, so the
    # locator and PLS detector run fine while the FEC config is wrong
    TX_MC = 6
    block = bank_block_symbols(C, mc=4, short=SHORT, frames_total=4)
    switches = []
    st = DVBS2BankStream(C, mc=4, short=SHORT, block_symbols=block,
                         ingest="f16", vote_frames=8,
                         on_modcod_switch=lambda cfg: switches.append(
                             (cfg.modcod, cfg.framesize, cfg.pilots)))
    y0, sent0 = _carrier(TX_MC, 131, 700, 0.005 * np.pi, 0.4)
    y1, sent1 = _carrier(TX_MC, 147, 700, -0.009 * np.pi, 0.8)
    n = 9 * 2 * block
    assert len(y0) >= n and len(y1) >= n
    outs = [bytearray(), bytearray()]
    for lo in range(0, n, 2 * block):
        for c, o in zip(st.feed([y0[lo:lo + 2 * block],
                                 y1[lo:lo + 2 * block]]), outs):
            o.extend(c)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    assert switches == [(TX_MC, "short", False)], switches
    assert st.cfg.modcod == TX_MC
    per_frame = st.cfg.kbch // 8 // 188
    m0 = _contiguous_match(bytes(outs[0]), sent0)
    m1 = _contiguous_match(bytes(outs[1]), sent1)
    # several post-switch blocks of byte-exact contiguous TS per carrier
    assert m0 >= 2 * st.F * per_frame and m1 >= 2 * st.F * per_frame

    # checkpoint after the switch restores the switched MODCOD
    blob = st.get_state()
    st2 = DVBS2BankStream(C, mc=4, short=SHORT, block_symbols=block,
                          ingest="f16", vote_frames=8)
    st2.set_state(blob)
    assert st2.cfg.pls_code == st.cfg.pls_code


def test_bank_diverging_carrier_no_switch():
    """One carrier on a different MODCOD must NOT rebuild the shared
    program — it is surfaced via detected_pls for the operator to split
    out (mixed bouquets use per-carrier DVBS2Streams)."""
    block = bank_block_symbols(C, mc=4, short=SHORT, frames_total=4)
    st = DVBS2BankStream(C, mc=4, short=SHORT, block_symbols=block,
                         ingest="f16", vote_frames=6)
    y0, sent0 = _carrier(4, 171, 700, 0.004 * np.pi, 0.3)
    y1, _ = _carrier(6, 181, 700, -0.007 * np.pi, 0.6)
    n = 5 * 2 * block
    outs = [bytearray(), bytearray()]
    for lo in range(0, n, 2 * block):
        for c, o in zip(st.feed([y0[lo:lo + 2 * block],
                                 y1[lo:lo + 2 * block]]), outs):
            o.extend(c)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    assert st.cfg.modcod == 4, "divergent carrier must not switch the bank"
    cfg6 = modcod.get_config(6, short=SHORT)
    assert st.detected_pls[1] == cfg6.pls_code
    assert st.detected_pls[0] in (-1, st.cfg.pls_code)
    # the matched carrier keeps decoding byte-exact throughout
    m0 = _contiguous_match(bytes(outs[0]), sent0)
    assert m0 >= 3 * st.F * (st.cfg.kbch // 8 // 188)
