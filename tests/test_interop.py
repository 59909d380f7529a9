"""Cross-validation against the compiled reference implementation.

These tests break the TX/RX loopback circularity flagged in round 1: every
constant and codec here is checked against the actual reference binaries
(native/refshim/libref_oracle.so compiles /root/reference's coding stack),
not against this repo's own TX oracles.

Conventions discovered and pinned by these tests:
  * LLR sign: positive = bit 0 on both sides (the reference hard-slices
    bit = (soft < 0), module_dvbs2_demod.cpp:358-360).
  * The reference's BBFrameLDPC::encode is sign-inconsistent with its own
    decoder (unused in the live RX path) — see test_ref_ldpc_encoder_quirk.
  * The reference demapper emits the m bits of each symbol in reversed
    order (constellation.cpp:256) and its deinterleaver compensates; our
    deinterleaver uses standard y0-first order, so comparisons apply the
    per-symbol reversal.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import ref_oracle as R  # noqa: E402

from dvbs_tpu.spec import (bch_spec, dvbs_fec, interleaver, ldpc_spec,  # noqa: E402
                           modcod, plheader, rs_spec, scrambling)

pytestmark = pytest.mark.skipif(not R.available(),
                                reason="reference oracle not buildable")

rng = np.random.default_rng(7)


# ---------------------------------------------------------------- constants
def test_pls_codewords_match_reference():
    assert np.array_equal(R.pls_codewords(), plheader.pls_codewords())


def test_sof_symbols_match_reference():
    assert np.allclose(R.sof_symbols(), plheader.sof_symbols(), atol=1e-6)


def test_pl_scrambler_sequence_matches_reference():
    n = 66420  # one normal QPSK frame payload worth
    assert np.array_equal(R.pl_scrambler_rn(n),
                          scrambling.pl_scrambler_sequence()[:n])


def test_modcod_table_matches_reference():
    for mc in range(1, 29):
        for short in (False, True):
            try:
                cfg = modcod.get_config(mc, short=short)
            except ValueError:
                continue
            ref = R.modcod_cfg(mc, short, False)
            assert ref["slots"] == cfg.slots, (mc, short)
            assert ref["constellation"] == \
                ["qpsk", "8psk", "16apsk", "32apsk"].index(cfg.constellation)
            assert ref["rate"] == R.RATES[cfg.rate], (mc, short)
            if cfg.g1 is not None:
                assert ref["g1"] == pytest.approx(cfg.g1, abs=1e-5)
            if cfg.g2 is not None:
                assert ref["g2"] == pytest.approx(cfg.g2, abs=1e-5)


# -------------------------------------------------------------------- LDPC
@pytest.mark.parametrize("mc,short", [(4, False), (4, True), (11, False),
                                      (13, True), (18, False), (24, False)])
def test_ldpc_our_encoder_accepted_by_ref_decoder(mc, short):
    """Our ETSI IRA encoder must produce codewords the reference decoder's
    syndrome check passes immediately (trials == 0)."""
    cfg = modcod.get_config(mc, short=short)
    code = ldpc_spec.get_code(cfg.ldpc_table)
    info = rng.integers(0, 2, code.K).astype(np.uint8)
    cw = code.encode(info)
    llr = np.where(cw > 0, -100, 100).astype(np.int8)
    hard, trials = R.ldpc_decode(llr, short, cfg.rate, max_trials=8)
    assert trials == 0
    assert np.array_equal(hard, cw)


def test_ldpc_noisy_decode_agrees_with_reference():
    """Same noisy int8 LLRs through the reference decoder (all 16 lanes)
    and through our QC decoder: both must recover the transmitted codeword."""
    from dvbs_tpu.ops import ldpc_qc
    cfg = modcod.get_config(4, short=True)        # C4: QPSK 1/2 short
    code = ldpc_spec.get_code(cfg.ldpc_table)
    W = R.ldpc_simd_width()
    info = rng.integers(0, 2, (W, code.K)).astype(np.uint8)
    cw = code.encode(info)
    sigma = 0.55
    x = 1.0 - 2.0 * cw.astype(np.float32)
    y = x + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr_f = 2.0 * y / sigma**2
    llr_i8 = np.clip(np.round(llr_f * 2), -127, 127).astype(np.int8)

    ref_hard, trials = R.ldpc_decode_batch(llr_i8, True, cfg.rate,
                                           max_trials=24)
    assert trials >= 0, "reference failed to decode the batch"
    assert np.array_equal(ref_hard, cw)

    our_hard, n_bad, _ = ldpc_qc.decode_qc(
        llr_i8.astype(np.float32), cfg.ldpc_table, n_iters=24)
    assert int(np.asarray(n_bad).max()) == 0
    assert np.array_equal(np.asarray(our_hard), cw)


def test_ref_ldpc_encoder_quirk_documented():
    """The reference's BBFrameLDPC::encode emits codewords its own decoder
    rejects (sign-inconsistent soft init, bbframe_ldpc.cpp:146-148); the
    plugin never uses it for RX. Pin the behavior so a future reference
    update is noticed."""
    code = ldpc_spec.get_code("B4")
    info = np.zeros(code.K, np.uint8)
    ref_cw = R.ldpc_encode(info, False, "1/2")
    assert not np.array_equal(ref_cw[code.K:], np.zeros(code.R)), \
        "reference encoder became linear; revisit interop assumptions"
    llr = np.where(ref_cw > 0, -100, 100).astype(np.int8)
    _, trials = R.ldpc_decode(llr, False, "1/2", max_trials=4)
    assert trials < 0


# --------------------------------------------------------------------- BCH
@pytest.mark.parametrize("mc,short", [(4, False), (4, True), (11, False),
                                      (13, False), (18, True)])
def test_bch_encode_matches_reference(mc, short):
    cfg = modcod.get_config(mc, short=short)
    msg = rng.integers(0, 2, cfg.kbch).astype(np.uint8)
    ours = bch_spec.encode(msg, cfg.framesize, cfg.rate)
    assert np.array_equal(ours, R.bch_encode(msg, short, cfg.rate))


def test_bch_cross_decoding():
    cfg = modcod.get_config(4, short=True)
    msg = rng.integers(0, 2, cfg.kbch).astype(np.uint8)
    cw = bch_spec.encode(msg, cfg.framesize, cfg.rate)
    bad = cw.copy()
    bad[rng.choice(cfg.nbch, 6, replace=False)] ^= 1
    ref_fixed, ncorr = R.bch_decode(bad, True, cfg.rate)
    assert ncorr == 6 and np.array_equal(ref_fixed, cw)
    our_bits, our_n = bch_spec.decode(bad, cfg.framesize, cfg.rate)
    assert our_n == 6 and np.array_equal(our_bits, cw[:len(our_bits)])


# -------------------------------------------------------- scramblers
def test_bb_descrambler_matches_reference():
    cfg = modcod.get_config(4, short=True)
    data = rng.integers(0, 256, cfg.kbch // 8).astype(np.uint8)
    assert np.array_equal(scrambling.bb_scramble_bytes(data),
                          R.bb_descramble(data, True, cfg.rate))


def test_dvbs_descrambler_matches_reference():
    pkts = rng.integers(0, 256, (8, 188)).astype(np.uint8)
    pkts[:, 0] = 0x47
    scr = scrambling.dvbs_scramble_group(pkts.reshape(-1)).reshape(8, 188)
    frame = np.zeros((8, 204), np.uint8)
    for p in range(8):
        frame[p] = rs_spec.encode(scr[p])
    ref_out = R.dvbs_descramble(frame.reshape(-1)).reshape(8, 204)
    assert np.array_equal(ref_out[:, :188], pkts)


# ------------------------------------------------------ deinterleavers
@pytest.mark.parametrize("mc,short", [(4, False), (11, False), (12, False),
                                      (13, False), (18, False), (24, False),
                                      (13, True)])
def test_s2_deinterleaver_matches_reference(mc, short):
    cfg = modcod.get_config(mc, short=short)
    m = cfg.mod_bits
    llr = rng.integers(-100, 100, cfg.nldpc).astype(np.int8)
    ours = llr[interleaver.deinterleave_perm(cfg.constellation,
                                             cfg.framesize, cfg.rate)]
    rev = llr.reshape(-1, m)[:, ::-1].reshape(-1)
    ref = R.s2_deinterleave(rev, cfg.constellation, short, cfg.rate)
    assert np.array_equal(ours, ref)


def test_forney_deinterleaver_matches_reference():
    ours = dvbs_fec.ConvDeinterleaver()
    ref = R.ForneyDeinterleaver()
    stream = rng.integers(0, 256, (6, 1632)).astype(np.uint8)
    for f in range(6):
        a = np.asarray(ours.process(stream[f].copy()), np.uint8).reshape(-1)
        assert np.array_equal(a, ref.deinterleave(stream[f]))


# ------------------------------------------------------------ CC / RS
def test_cc_encoder_matches_reference():
    bits = rng.integers(0, 2, 2048).astype(np.uint8)
    assert np.array_equal(dvbs_fec.cc_encode(bits).reshape(-1),
                          R.cc_encode(bits))


def test_cc_cross_decoding():
    bits = rng.integers(0, 2, 2054).astype(np.uint8)
    coded = dvbs_fec.cc_encode(bits).reshape(-1)
    soft = np.where(coded > 0, 255, 0).astype(np.uint8)
    assert np.array_equal(R.cc_decode(soft, 2048), bits[:2048])

    from dvbs_tpu.ops import viterbi as our_vit
    llr = np.where(coded > 0, -20.0, 20.0).astype(np.float32)
    dec = our_vit.decode_stream(llr.reshape(-1, 2))
    assert np.array_equal(dec[:2040], bits[:2040])


def test_rs_cross_decoding():
    msg = rng.integers(0, 256, 188).astype(np.uint8)
    cw = rs_spec.encode(msg)
    bad = cw.copy()
    # corrupt data bytes only: the reference counts corrections in the
    # 188-byte data region (dvbs_reedsolomon.h:39-44)
    bad[rng.choice(188, 4, replace=False)] ^= 0x5A
    ref_fixed, nerr = R.rs_decode(bad)
    assert nerr == 4 and np.array_equal(ref_fixed[:188], msg)
    our_fixed, our_n = rs_spec.decode(bad)
    assert np.array_equal(np.asarray(our_fixed)[:188], msg)


# ------------------------------------------- auto-rate Viterbi (DVB-S)
def test_reference_viterbi_locks_on_our_tx():
    """The reference's full Viterbi_DVBS (phase/rate/shift hypothesis
    search) must lock on soft symbols produced by our DVB-S TX oracle."""
    from dvbs_tpu.tx.dvbs_mod import DVBSModulator, random_ts_groups
    mod = DVBSModulator(rate="1/2")
    ts = random_ts_groups(24, seed=3)
    syms = mod.ts_to_symbols(ts)
    soft = np.zeros(2 * len(syms), np.int8)
    soft[0::2] = np.clip(np.round(syms.real * 100), -127, 127)
    soft[1::2] = np.clip(np.round(syms.imag * 100), -127, 127)
    # feed canonical VIT_BUF_SIZE=8192 chunks like the plugin
    # (dvbs_defines.h:3). The reference first false-locks at 5/6 — its
    # last-hypothesis-wins IDLE search plus erasure-skipping get_ber pass
    # on a clean 1/2 stream — then the 20-strike watchdog drops it back
    # and it settles at 1/2; the tail of the stream decodes cleanly.
    vit = R.ViterbiDVBS(0.15, 20, 8192)
    out = bytearray()
    for i in range(0, len(soft) - 8192, 8192):
        out.extend(vit.work(soft[i:i + 8192]).tobytes())
    assert vit.state == 1, "ST_SYNCED (viterbi_all.cpp:6) not reached"
    assert vit.rate == 0, "should settle at RATE_1_2"
    assert vit.ber < 0.02
    # the decoded bit stream (one bit per byte) must deframe into TS
    # super-frames through the reference deframer
    defra = R.TSDeframer()
    frames = defra.work(np.frombuffer(bytes(out), np.uint8))
    assert len(frames) >= 10
    syncs = frames[:, ::204]
    assert np.all((syncs == 0x47) | (syncs == 0xB8))


# ------------------------------------------------------ TS deframer
def test_ts_deframer_cross():
    """A scrambled+RS-encoded+interleaved DVB-S bit stream deframes to the
    same super-frames through the reference deframer and ours."""
    from dvbs_tpu.io.ts_deframer import TSDeframer as OurDeframer
    n_groups = 8
    intl = dvbs_fec.ConvInterleaver()
    frames = []
    for g in range(n_groups):
        pkts = rng.integers(0, 256, (8, 188)).astype(np.uint8)
        pkts[:, 0] = 0x47
        scr = scrambling.dvbs_scramble_group(pkts.reshape(-1)).reshape(8, 188)
        enc = np.stack([rs_spec.encode(scr[p]) for p in range(8)])
        frames.append(np.asarray(intl.process(enc.reshape(-1)), np.uint8))
    stream = np.concatenate([rng.integers(0, 256, 97).astype(np.uint8)] +
                            frames)
    bits = np.unpackbits(stream.reshape(-1))

    ref = R.TSDeframer()
    ref_frames = ref.work(bits)
    ours = OurDeframer()
    our_frames = np.asarray(ours.feed(bits))
    assert len(ref_frames) > 0
    # both must find the same aligned super-frames (ours may sync one
    # frame earlier/later at stream start; compare the common tail)
    k = min(len(ref_frames), len(our_frames))
    assert k >= len(ref_frames) - 1
    assert np.array_equal(ref_frames[-k:], our_frames[-k:])


# ------------------------------- DVB-S e2e, TX = reference encoders
def test_dvbs_rx_decodes_reference_encoded_capture():
    """Breaks the DVB-S TX/RX loopback circularity: the capture's whole
    FEC chain runs through the REFERENCE's own codecs via refshim —
    energy-dispersal PRBS (dvbs_scrambling.h mask, probed with a zero
    payload), RS(204,188) parity from libcorrect with the reference's
    parameters (ref_rs_encode), the reference's TX-direction Forney
    interleaver (dvbs_interleaving.h:45-56), and the reference CC
    encoder (cc_encoder.cpp:92-118) — then our full RX (front end +
    Viterbi + deframer + RS + descramble) must recover the TS bytes.
    Only QPSK mapping + RRC shaping (not FEC) are local."""
    from dvbs_tpu.models.dvbs import DVBSReceiver
    from dvbs_tpu.tx import channel
    n_groups = 30
    pkts = rng.integers(0, 256, (n_groups * 8, 188)).astype(np.uint8)
    pkts[:, 0] = 0x47

    # dispersal mask from the reference PRBS: descramble a zero-payload
    # group (mask = 0 XOR prbs bytes; sync bytes untouched by the PRBS)
    z = np.zeros((8, 204), np.uint8)
    z[:, 0] = 0x47
    z[0, 0] = 0xB8
    m = R.dvbs_descramble(z.reshape(-1)).reshape(8, 204)
    mask = m[:, :188].copy()
    mask[:, 0] = 0

    stream204 = []
    for g in range(n_groups):
        grp = pkts[g * 8:(g + 1) * 8] ^ mask
        grp[0, 0] = 0xB8            # inverted sync marks the group start
        for k in range(8):
            stream204.append(R.rs_encode(grp[k]))
    stream = np.concatenate(stream204)

    inter = R.ForneyDeinterleaver()
    interleaved = inter.interleave(stream)

    bits = np.unpackbits(interleaved)
    xy = R.cc_encode(bits)                       # [2n] serial X,Y
    pairs = xy.reshape(-1, 2).astype(np.float32)
    syms = ((1 - 2 * pairs[:, 0]) + 1j * (1 - 2 * pairs[:, 1])) \
        .astype(np.complex64) / np.sqrt(2)

    x = channel.shape(syms, sps=2)
    y = channel.impair(x, snr_db=14.0, cfo=0.003 * np.pi,
                       delay_samples=0.4, seed=77)

    rx = DVBSReceiver(rate="1/2", block_symbols=1 << 16)
    got = []
    used = 0
    n = 2 * (1 << 16)
    for _ in range(3):
        if used + n > len(y):
            break
        res = rx.process_block(y[used:used + n])
        used += rx.last_consumed
        got.append(res.ts_packets)
    got = np.concatenate(got) if got else np.zeros((0, 188), np.uint8)
    assert rx.locked and rx.rate == "1/2"
    assert len(got) >= 24, f"only {len(got)} TS packets"
    sset = {r.tobytes(): i for i, r in enumerate(pkts)}
    idx = [sset.get(r.tobytes(), -1) for r in got]
    matched = [i for i in idx if i >= 0]
    # interleaver warm-up corrupts the first packets; after that the
    # recovered TS must be a contiguous run of the transmitted stream
    assert len(matched) >= len(got) - 16, f"{len(matched)}/{len(got)}"
    assert np.all(np.diff(matched) == 1)


# ---------------------------------------------------- soft demapper
@pytest.mark.parametrize("kind,mcn,sigma", [
    ("qpsk", 4, 0.15), ("qpsk", 4, 0.05),        # low noise: halving path
    ("8psk", 12, 0.12),
    ("16apsk", 18, 0.12),                        # rate 2/3 gamma
    ("16apsk", 23, 0.10),                        # rate 9/10 gamma (radii move)
    ("32apsk", 24, 0.10),                        # rate 3/4 gamma1/gamma2
    ("32apsk", 28, 0.08),                        # rate 9/10 gammas
])
def test_soft_demapper_matches_reference(kind, mcn, sigma):
    """ops/demap.soft_demap vs the reference's exact-LLR demod_soft_calc
    (constellation.cpp:205-270) compiled from source: same internal
    scale chain (const_amp/const_prescale/const_sca incl. the APSK
    const_sca=1 override), gamma-dependent APSK radii, and the
    clamp-by-halving int8 conversion. The reference emits each symbol's
    m bits reversed (constellation.cpp:256) — compare reversed, as the
    deinterleaver tests do. The only tolerated difference is the C
    float->int8 truncation (<= 1 LSB) plus rare halving-boundary flips."""
    from dvbs_tpu.ops import demap
    from dvbs_tpu.spec import constellations
    import jax.numpy as jnp
    cfg = modcod.get_config(mcn, short=False)
    assert cfg.constellation == kind
    pts = constellations.points(kind, cfg.g1, cfg.g2)
    n = 4000
    idx = rng.integers(0, len(pts), n)
    syms = (pts[idx] + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)
    ref = R.constellation_soft_demod(syms, kind, cfg.g1 or 0.0,
                                     cfg.g2 or 0.0, 1.0)[:, ::-1]
    ours = np.asarray(demap.soft_demap(jnp.asarray(syms), kind,
                                       cfg.g1, cfg.g2))
    d = np.abs(ours - ref)
    # median ~0.5: the C cast truncates toward zero, ours stays float
    assert np.median(d) <= 0.55
    # > 1 LSB only at halving boundaries (a value straddling 127 in
    # float lands on x vs x/2); those must be rare
    assert (d > 1.5).mean() < 0.005, f"max {d.max()} at {(d > 1.5).mean()}"
    strong = np.abs(ref) >= 2
    assert (np.sign(ours) == np.sign(ref))[strong].all()


# ------------------------------------------------- BBFrame TS parser
def test_bbframe_ts_parser_cross_ts_mode():
    from dvbs_tpu.io.bbframe_parser import BBFrameParser
    from dvbs_tpu.tx.dvbs2_mod import ts_to_bbframes, random_ts_packets
    cfg = modcod.get_config(4, short=True)
    pkts = random_ts_packets(64, seed=9)
    bb = ts_to_bbframes(pkts, cfg)          # scrambled BBFRAMEs
    descrambled = np.stack([scrambling.bb_scramble_bytes(f) for f in bb])
    ref = R.BBFrameTSParser(cfg.kbch)
    ref_out = ref.work(descrambled)
    ours = BBFrameParser(cfg.kbch)
    our_out = ours.feed(descrambled)
    assert len(ref_out) > 0
    assert ref_out == our_out
    hdr = ref.header()
    assert hdr["ts_gs"] == 0b11
    assert hdr["dfl"] > 0


def test_bbframe_ts_parser_cross_gse_mode():
    from dvbs_tpu.io.bbframe_parser import BBFrameParser
    from dvbs_tpu.tx import gse_mod
    cfg = modcod.get_config(4, short=True)
    pkts = []
    for i, n in enumerate((64, 700, 1400, 9000, 120)):
        pdu = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        if n > 1000:
            # fragments must fit the short-frame 869-byte data field
            pkts += gse_mod.gse_packets_fragmented(pdu, frag_id=i, chunk=800)
        else:
            pkts.append(gse_mod.gse_packet_unfrag(pdu))
    bb = gse_mod.gse_to_bbframes(pkts, cfg.kbch)
    descrambled = np.stack([scrambling.bb_scramble_bytes(f) for f in bb])
    ref = R.BBFrameTSParser(cfg.kbch)
    ref_out = ref.work(descrambled)
    ours = BBFrameParser(cfg.kbch)
    our_out = ours.feed(descrambled)
    assert len(ref_out) > 0
    assert ref_out == our_out


# ------------------------------------------- end-to-end over RF capture
def test_e2e_capture_to_identical_ts():
    """IQ capture (our TX + channel impairments) -> our full RX chain
    -> descrambled BBFRAMEs -> the *reference* TS parser and ours produce
    byte-identical TS output."""
    from dvbs_tpu.models.dvbs2 import DVBS2Receiver
    from dvbs_tpu.io.bbframe_parser import BBFrameParser
    from dvbs_tpu.tx import dvbs2_mod, channel
    cfg = modcod.get_config(4, short=True)
    pkts = dvbs2_mod.random_ts_packets(600, seed=11)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=4.0, cfo=0.02 * np.pi, delay_samples=0.3,
                       seed=12)
    rx = DVBS2Receiver(mc=4, short=True, block_symbols=1 << 15)
    all_frames = []
    for b in range(3):
        blk = y[2 * b * (1 << 15):2 * (b + 1) * (1 << 15)]
        res = rx.process_symbols_block(blk)
        if res.frame_ok.any():
            all_frames.append(res.bbframes)
    assert all_frames, "no frames decoded"
    # parity on each CONTIGUOUS decoded run: the fixed non-overlapping
    # block windows skip frames between blocks, and on such a splice the
    # two parsers intentionally diverge (checked below)
    total = 0
    for run in all_frames:
        ref = R.BBFrameTSParser(cfg.kbch)
        ours = BBFrameParser(cfg.kbch)
        ref_out = ref.work(run)
        our_out = ours.feed(run)
        assert ref_out == our_out
        total += len(ref_out)
    assert total > 1880
    if len(all_frames) > 1:
        # documented divergence on a SPLICED sequence: the reference
        # free-runs across the jump (bbframe_ts_parser.cpp:193 disables
        # its own check — every packet after the splice is byte-shifted)
        # while our SYNCD-consistency check resyncs, so OUR packets all
        # remain genuine TX packets
        frames = np.concatenate(all_frames)
        ours = BBFrameParser(cfg.kbch)
        our_out = ours.feed(frames)
        assert ours.sync_errors >= 1
        got = np.frombuffer(our_out, np.uint8).reshape(-1, 188)
        sent = {r.tobytes() for r in pkts.reshape(-1, 188)}
        assert all(r.tobytes() in sent for r in got)
