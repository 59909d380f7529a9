"""End-to-end DVB-S tests: TX oracle -> channel -> auto-locking receiver."""
import numpy as np
import pytest

from dvbs_tpu.tx import dvbs_mod, channel
from dvbs_tpu.models.dvbs import DVBSReceiver
from dvbs_tpu.spec import dvbs_fec


def _run(rate="1/2", snr_db=12.0, cfo=0.0, phase=0.7, delay=0.4,
         sco_ppm=10.0, n_groups=40, seed=0, n_blocks=3,
         block_symbols=1 << 16, fixed_rate=None):
    ts = dvbs_mod.random_ts_groups(n_groups, seed=seed)
    tx = dvbs_mod.DVBSModulator(rate=rate)
    syms = tx.ts_to_symbols(ts)
    x = channel.shape(syms, sps=2)
    y = channel.impair(x, snr_db=snr_db, cfo=cfo, phase=phase,
                       delay_samples=delay, sco_ppm=sco_ppm, seed=seed + 1)
    rx = DVBSReceiver(rate=fixed_rate, block_symbols=block_symbols)
    pkts = []
    n = 2 * block_symbols
    used = 0
    for b in range(n_blocks):
        if used + n > len(y):
            break
        res = rx.process_block(y[used:used + n])
        used += rx.last_consumed   # API contract: advance by consumed
        pkts.append(res.ts_packets)
    got = np.concatenate(pkts) if pkts else np.zeros((0, 188), np.uint8)
    return got, ts.reshape(-1, 188), rx


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_dvbs_e2e_rate(rate):
    got, sent, rx = _run(rate=rate, n_groups=60)
    assert rx.locked and rx.rate == rate
    assert rx.ber < 0.05
    sset = {r.tobytes(): i for i, r in enumerate(sent)}
    idx = [sset.get(r.tobytes(), -1) for r in got]
    matched = [i for i in idx if i >= 0]
    # deinterleaver warm-up corrupts the first ~12 packets; after that the
    # stream must be contiguous
    assert len(matched) >= len(got) - 16, f"{len(matched)}/{len(got)}"
    runs = np.diff(matched)
    assert np.all(runs == 1)


def test_dvbs_e2e_rotated_carrier():
    # phase near 90deg: receiver must lock via rotation hypothesis
    got, sent, rx = _run(rate="1/2", phase=np.pi / 2 + 0.1, n_groups=60)
    assert rx.locked
    sset = {r.tobytes() for r in sent}
    matched = sum(1 for r in got if r.tobytes() in sset)
    assert matched >= len(got) - 16


def test_dvbs_e2e_inverted_carrier():
    # phase near 180deg: deframer must detect inverted sync
    got, sent, rx = _run(rate="1/2", phase=np.pi + 0.05, n_groups=60)
    assert rx.locked
    sset = {r.tobytes() for r in sent}
    matched = sum(1 for r in got if r.tobytes() in sset)
    assert matched >= len(got) - 16


def test_dvbs_e2e_noisy():
    got, sent, rx = _run(rate="1/2", snr_db=5.0, cfo=0.01 * np.pi,
                         n_groups=60)
    assert rx.locked
    sset = {r.tobytes() for r in sent}
    matched = sum(1 for r in got if r.tobytes() in sset)
    assert matched >= len(got) - 16
    assert rx.rs_avg_errors < 2.0


# ---------------------------------------------------------------- stream
# DVBSStream checkpoint/resume + reference metric semantics
# (rolling 30-block averages, real frame counts,
# get_state/set_state parity with the S2 driver)

def _stream_signal(n_groups=120, seed=3):
    from dvbs_tpu.tx import dvbs_mod, channel
    ts = dvbs_mod.random_ts_groups(n_groups, seed=seed)
    tx = dvbs_mod.DVBSModulator(rate="1/2")
    syms = tx.ts_to_symbols(ts)
    x = channel.shape(syms, sps=2)
    y = channel.impair(x, snr_db=9.0, cfo=0.004 * np.pi, phase=0.4,
                       delay_samples=0.3, sco_ppm=10.0, seed=seed + 1)
    return y, ts


def test_dvbs_stream_checkpoint_resume():
    from dvbs_tpu.models.dvbs import DVBSStream
    y, ts = _stream_signal()
    bs = 1 << 15
    chunk = 3 * bs                       # feed in odd-sized host chunks

    ref = DVBSStream(block_symbols=bs)
    out_ref = b"".join(ref.feed(y[i:i + chunk])
                       for i in range(0, len(y), chunk))

    a = DVBSStream(block_symbols=bs)
    cut = (len(y) // chunk // 2) * chunk
    out1 = b"".join(a.feed(y[i:i + chunk]) for i in range(0, cut, chunk))
    st = a.get_state()

    b = DVBSStream(block_symbols=bs)
    b.set_state(st)
    out2 = b"".join(b.feed(y[i:i + chunk]) for i in range(cut, len(y), chunk))

    assert out1 + out2 == out_ref, "restore-and-continue != uninterrupted"
    # restored stream keeps counting where the snapshot left off
    assert b.metrics.frames_seen == ref.metrics.frames_seen
    assert b.metrics.frames_ok == ref.metrics.frames_ok
    assert b.metrics.viterbi_sig_level == ref.metrics.viterbi_sig_level


def test_dvbs_stream_metric_semantics():
    from dvbs_tpu.models.dvbs import DVBSStream
    y, ts = _stream_signal()
    s = DVBSStream(block_symbols=1 << 15)
    out = s.feed(y)
    m = s.metrics
    got = np.frombuffer(out, np.uint8).reshape(-1, 188)
    # frames_seen counts 1632-byte super-frames (8 TS packets each), not
    # processed blocks; the emitted TS packet count must agree with the
    # RS-group count (every group emits 8 packets)
    assert m.frames_seen > 8            # far more frames than blocks fed
    assert m.frames_seen * 8 >= len(got)
    assert 0 < m.frames_ok <= m.frames_seen
    # clean signal: nearly every group decodes
    assert m.frames_ok >= m.frames_seen - 4
    # 30-block rolling sig level: clean stream sits near 100
    assert m.viterbi_sig_level > 95.0
    assert m.rs_avg_errors < 1.0
    assert m.viterbi_lock and m.viterbi_rate == "1/2"


def test_dvbs_deframer_state_blob_interchangeable():
    """python <-> native deframer state blobs share one format."""
    from dvbs_tpu.io.ts_deframer import TSDeframer as PyDeframer
    from dvbs_tpu.io import native as io_native
    from dvbs_tpu.spec import scrambling, rs_spec
    ts = dvbs_mod.random_ts_groups(24, seed=9)
    # bits as the deframer sees them: post-Viterbi hard bits = the
    # scrambled+RS-coded+interleaved byte stream
    chunks = []
    for grp in ts.reshape(-1, 8 * 188):
        disp = scrambling.dvbs_scramble_group(grp)
        chunks.append(rs_spec.encode(disp.reshape(8, 188)).reshape(-1))
    stream = dvbs_fec.ConvInterleaver().process(np.concatenate(chunks))
    frames_bits = np.unpackbits(stream)
    cut = len(frames_bits) // 2 + 131    # mid-frame, unaligned

    py = PyDeframer()
    f1 = py.feed(frames_bits[:cut])
    blob = py.get_state()

    py2 = PyDeframer()
    py2.set_state(blob)
    f2 = py2.feed(frames_bits[cut:])
    ref = PyDeframer().feed(frames_bits)
    both = np.concatenate([f1, f2]) if len(f1) or len(f2) else f1
    assert both.shape == ref.shape and (both == ref).all()

    if io_native.available():
        nat = io_native.NativeTSDeframer()
        nat.set_state(blob)              # python blob into C++ deframer
        f2n = nat.feed(frames_bits[cut:])
        assert f2n.shape == f2.shape and (f2n == f2).all()
        blob_n = nat.get_state()
        py3 = PyDeframer()
        py3.set_state(blob_n)            # C++ blob back into python
        assert py3.frames_ok == nat.frames_ok


def test_dvbs_native_tail_equivalence():
    """The C++ fused host tail (deframe+deinterleave+RS+descramble,
    native/dvbs_native.cpp dvbstail_*) is byte-identical to the python
    chain through the full receiver, with the same metrics — and a
    checkpoint written by the native-tail receiver restores into a
    python-tail receiver mid-stream (one state format)."""
    from dvbs_tpu.io import native as io_native
    if not io_native.available():
        import pytest
        pytest.skip("native library not built")
    from dvbs_tpu.models.dvbs import DVBSStream
    y, ts = _stream_signal()
    bs = 1 << 15
    chunk = 3 * bs

    nat = DVBSStream(block_symbols=bs, native_tail=True)
    pyt = DVBSStream(block_symbols=bs, native_tail=False)
    out_n = b"".join(nat.feed(y[i:i + chunk])
                     for i in range(0, len(y), chunk))
    out_p = b"".join(pyt.feed(y[i:i + chunk])
                     for i in range(0, len(y), chunk))
    assert out_n == out_p and len(out_n) > 188 * 50
    for k in ("frames_seen", "frames_ok", "rs_avg_errors",
              "deframer_errors", "viterbi_sig_level"):
        assert getattr(nat.metrics, k) == getattr(pyt.metrics, k), k

    # cross-restore: native checkpoint -> python receiver (and back)
    nat2 = DVBSStream(block_symbols=bs, native_tail=True)
    cut = (len(y) // chunk // 2) * chunk
    out1 = b"".join(nat2.feed(y[i:i + chunk]) for i in range(0, cut, chunk))
    st = nat2.get_state()
    py2 = DVBSStream(block_symbols=bs, native_tail=False)
    py2.set_state(st)
    out2 = b"".join(py2.feed(y[i:i + chunk])
                    for i in range(cut, len(y), chunk))
    assert out1 + out2 == out_p, "native->python restore != uninterrupted"
