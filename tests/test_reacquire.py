"""Frame-sync robustness: reacquisition after signal loss and timing
steps (the reference re-correlates the SOF+PLS at
every frame boundary, dvbs2_pl_sync.cpp:102-161; our batched locator
gets the same resilience from the per-frame relocation fallback in
plsync.locate_frames plus the piecewise tau path in
frontend.recover_symbols_full)."""
import numpy as np

from dvbs_tpu.spec import modcod
from dvbs_tpu.tx import dvbs2_mod, channel
from dvbs_tpu.models.driver import DVBS2Stream

MC, SHORT = 4, True
BS = 1 << 15                       # block_symbols


def _signal(seed, n_pkts, cfo, delay):
    cfg = modcod.get_config(MC, short=SHORT)
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=8.0, cfo=cfo, delay_samples=delay,
                       sco_ppm=10.0, seed=seed + 1)
    return y, pkts.reshape(-1, 188)


def _contig_tail(got: bytes, sent: np.ndarray) -> int:
    """Longest contiguous run of sent's packets ENDING the output."""
    g = np.frombuffer(got, np.uint8)
    g = g[:len(g) // 188 * 188].reshape(-1, 188)
    run = 0
    sb = sent.tobytes()
    # find the last output packet in sent, then walk backwards
    idx = [sb.find(p.tobytes()) // 188 if sb.find(p.tobytes()) >= 0 else -1
           for p in g]
    for i in range(len(g) - 1, -1, -1):
        if idx[i] < 0:
            break
        if run and idx[i] != idx[i + 1] - 1:
            break
        run += 1
    return run


def test_signal_loss_then_reacquire_new_delay_cfo():
    """Signal -> noise -> signal at a NEW delay/CFO: at most ~1 block of
    the reappeared signal may be lost to reacquisition; everything after
    decodes contiguously."""
    yA, pA = _signal(31, 500, 0.008 * np.pi, 0.2)
    yB, pB = _signal(47, 500, -0.015 * np.pi, 7.35)
    n = 2 * BS
    rng = np.random.default_rng(3)
    noise = 0.9 * (rng.standard_normal(3 * n // 2) +
                   1j * rng.standard_normal(3 * n // 2)).astype(np.complex64)
    nA = 3 * n
    st = DVBS2Stream(mc=MC, short=SHORT, block_symbols=BS)
    outA = st.feed(yA[:nA])
    okA = st.metrics.frames_ok
    assert okA >= 2 * st.rx.n_frames, "must decode before the loss"
    st.feed(noise)
    ok_mid = st.metrics.frames_ok
    outB = bytearray()
    nB = 5 * n
    for lo in range(0, nB, n):
        outB.extend(st.feed(yB[lo:lo + n]))
    okB = st.metrics.frames_ok - ok_mid
    F = st.rx.n_frames
    # fed ~5 blocks of B minus pipeline tail: >= 3 blocks' frames must
    # decode (reacquisition costs at most about one block)
    assert okB >= 3 * F, f"only {okB} frames after reappearance"
    per_frame = st.cfg.kbch // 8 // 188
    assert _contig_tail(bytes(outB), pB) >= (okB - F) * per_frame


def test_timing_step_midstream():
    """A 3.3-sample timing step mid-stream (splice/cable swap): the
    piecewise tau path confines the damage to the step's own
    neighbourhood — no more than ~one block of frames is lost, and the
    stream returns to full decode immediately after."""
    cfg = modcod.get_config(MC, short=SHORT)
    pkts = dvbs2_mod.random_ts_packets(1500, seed=8)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y1 = channel.impair(x, snr_db=8.0, cfo=0.006 * np.pi,
                        delay_samples=0.2, seed=9)
    y2 = channel.impair(x, snr_db=8.0, cfo=0.006 * np.pi,
                        delay_samples=3.5, seed=9)
    n = 2 * BS
    P = 3 * n + n // 3              # step lands mid-block 4
    m = min(len(y1), len(y2))
    y = np.concatenate([y1[:P], y2[P:m]])
    st = DVBS2Stream(mc=MC, short=SHORT, block_symbols=BS)
    out = bytearray()
    for lo in range(0, len(y), n):
        out.extend(st.feed(y[lo:lo + n]))
    F = st.rx.n_frames
    blocks = st.stats.blocks
    lost = st.metrics.frames_seen - st.metrics.frames_ok
    assert lost <= F + 1, \
        f"timing step lost {lost} frames (> one block of {F})"
    # the stream ends fully recovered: the output tail is contiguous
    sent = pkts.reshape(-1, 188)
    assert _contig_tail(bytes(out), sent) >= 2 * F * (cfg.kbch // 8 // 188)
