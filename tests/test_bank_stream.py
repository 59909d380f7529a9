"""DVBS2BankStream: continuous multi-carrier streaming on CPU.

The production driver over the fused carrier bank:
cross-block frame-boundary continuity per carrier, pipelined look-ahead
dispatch, escalation/BCH gating, native parse with mark_gap, and
checkpointing — asserted byte-exact against each carrier's own TX
stream across >= 6 block seams.
"""
import numpy as np
import pytest

from dvbs_tpu.spec import modcod
from dvbs_tpu.tx import dvbs2_mod, channel
from dvbs_tpu.models.bank_stream import DVBS2BankStream
from dvbs_tpu.parallel.mesh import bank_block_symbols

MC, SHORT = 4, True
C = 2


def _carrier(seed, n_pkts, cfo, delay, snr=7.0, sco=15.0):
    cfg = modcod.get_config(MC, short=SHORT)
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=snr, cfo=cfo, delay_samples=delay,
                       sco_ppm=sco, seed=seed + 1)
    return y, pkts.reshape(-1, 188)


def _contiguous_match(got: bytes, sent: np.ndarray) -> int:
    """got must be a CONTIGUOUS run of sent's packets (the interop
    standard, test_interop.py:344-351). Returns packets matched."""
    g = np.frombuffer(got, np.uint8)
    assert len(g) % 188 == 0
    gp = g.reshape(-1, 188)
    if len(gp) == 0:
        return 0
    sb = sent.tobytes()
    i0 = sb.find(gp[0].tobytes())
    assert i0 >= 0 and i0 % 188 == 0, "first output packet not in TX stream"
    k0 = i0 // 188
    assert k0 + len(gp) <= len(sent), "output longer than TX tail"
    assert np.array_equal(gp, sent[k0:k0 + len(gp)]), \
        "output is not a contiguous run of the TX packets"
    return len(gp)


@pytest.fixture(scope="module")
def stream_run():
    block = bank_block_symbols(C, mc=MC, short=SHORT, frames_total=4)
    st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=block,
                         ingest="f16")
    n_blocks = 7
    need = n_blocks * 2 * block + 4 * block
    y0, sent0 = _carrier(31, 900, 0.006 * np.pi, 0.3)
    y1, sent1 = _carrier(47, 900, -0.011 * np.pi, 0.7)
    assert len(y0) >= need and len(y1) >= need
    # feed in uneven chunks so block boundaries never align with feeds
    outs = [bytearray(), bytearray()]
    chunk = 2 * block // 3 * 2
    pos = 0
    while pos < need:
        e = min(pos + chunk, need)
        for c, o in zip(st.feed([y0[pos:e], y1[pos:e]]), outs):
            o.extend(c)
        pos = e
    return st, bytes(outs[0]), bytes(outs[1]), sent0, sent1, block


def test_bank_stream_continuous_ts(stream_run):
    st, o0, o1, sent0, sent1, block = stream_run
    m0 = _contiguous_match(o0, sent0)
    m1 = _contiguous_match(o1, sent1)
    # >= 6 block seams crossed, both carriers produce sustained output
    assert (st.frames_seen >= 7 * st.F).all()
    assert (st.frames_ok == st.frames_seen).all(), \
        "every frame must decode across all block seams"
    per_frame = st.cfg.kbch // 8 // 188
    assert m0 >= 6 * st.F * per_frame and m1 >= 6 * st.F * per_frame
    assert o0 != o1


def test_bank_stream_checkpoint_resume(stream_run):
    """Restore-equals-uninterrupted across the bank driver."""
    st_ref, *_ = stream_run
    block = bank_block_symbols(C, mc=MC, short=SHORT, frames_total=4)
    y0, sent0 = _carrier(61, 500, 0.004 * np.pi, 0.4)
    y1, sent1 = _carrier(62, 500, -0.007 * np.pi, 0.6)
    n = 2 * block

    def run(split):
        st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=block,
                             ingest="f16")
        out = [bytearray(), bytearray()]
        for c, o in zip(st.feed([y0[:split], y1[:split]]), out):
            o.extend(c)
        blob = st.get_state()
        st2 = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=block,
                              ingest="f16")
        st2.set_state(blob)
        for c, o in zip(st2.feed([y0[split:4 * n], y1[split:4 * n]]), out):
            o.extend(c)
        return bytes(out[0]), bytes(out[1])

    a = run(split=2 * n + n // 2)
    b = run(split=n // 3)
    assert a == b and len(a[0]) > 0 and len(a[1]) > 0
    _contiguous_match(a[0], sent0)
    _contiguous_match(a[1], sent1)


def test_bank_stream_dead_carrier_isolated():
    """A carrier with no signal (pure noise) must not disturb the other
    carrier: its frames fail the quality/BCH gates and its parser gets
    gaps, while the live carrier stays contiguous."""
    block = bank_block_symbols(C, mc=MC, short=SHORT, frames_total=4)
    st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=block,
                         ingest="f16")
    y0, sent0 = _carrier(91, 500, 0.005 * np.pi, 0.2)
    rng = np.random.default_rng(7)
    n = 5 * 2 * block
    noise = 0.8 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                   ).astype(np.complex64)
    outs = [bytearray(), bytearray()]
    for lo in range(0, n, 2 * block):
        for c, o in zip(st.feed([y0[lo:lo + 2 * block],
                                 noise[lo:lo + 2 * block]]), outs):
            o.extend(c)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    assert st.frames_ok[0] == st.frames_seen[0] >= 3 * st.F
    assert st.frames_ok[1] == 0, "noise carrier must emit no frames"
    assert len(outs[1]) == 0
    m0 = _contiguous_match(bytes(outs[0]), sent0)
    assert m0 >= 2 * st.F * (st.cfg.kbch // 8 // 188)


def test_bank_stream_escalation_path():
    """Starve the first FEC pass (n_iters=2) so frames fail LDPC and the
    full-budget escalation rerun must recover them — the bad()-gated
    retry of the reference (layered_decoder.hh:121-133) at bank scale."""
    block = bank_block_symbols(C, mc=MC, short=SHORT, frames_total=4)
    st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=block,
                         ingest="f16", n_iters=1,
                         max_ldpc_trials=40)
    y0, sent0 = _carrier(95, 400, 0.004 * np.pi, 0.3, snr=3.8)
    y1, sent1 = _carrier(96, 400, -0.006 * np.pi, 0.6, snr=3.8)
    n = 3 * 2 * block
    outs = [bytearray(), bytearray()]
    for lo in range(0, n, 2 * block):
        for c, o in zip(st.feed([y0[lo:lo + 2 * block],
                                 y1[lo:lo + 2 * block]]), outs):
            o.extend(c)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    assert (st.frames_ok == st.frames_seen).all(), \
        f"escalation must recover all frames: {st.frames_ok}"
    # the escalation actually fired: reported trials exceed the pass-1
    # budget (finalize adds n_iters + retry trials for retried lanes)
    assert (st.ldpc_trials > 1).any(), st.ldpc_trials
    _contiguous_match(bytes(outs[0]), sent0)
    _contiguous_match(bytes(outs[1]), sent1)
