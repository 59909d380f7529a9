#!/usr/bin/env python3
"""Benchmark: 8-carrier DVB-S2 QPSK 1/2 normal-frame demodulation, one GPU.

This is the BASELINE.json north-star configuration: an 8-carrier channel
bank demodulated END TO END — front end + sync + demap + LDPC (the int8
per-frame kernel of ops/routes.py) + BCH syndromes + BB descramble all on device, TS
parse in native C++ on host — with the carriers vmapped into one device
program per block. Both the headline timing and the end-to-end loop run
the PRODUCTION program: the same fused step that DVBS2BankStream (the
shipped multi-carrier streaming driver, models/bank_stream.py and CLI
--carrier) executes, and the e2e loop IS DVBS2BankStream.feed streaming
distinct continuous signals across block seams.

Headline value = DEVICE-RESIDENT throughput (input already in device
memory): the official metric per BASELINE.md "Official metric" — a
compute number; PCIe/DMA feeds a real host at GB/s, far above this
workload's 16 MB/s-per-100-Msamp/s need at cs4.

Quality gates (the interop standard, test_interop.py): every carrier's
decoded TS bytes must be a byte-exact CONTIGUOUS RUN of ITS OWN
transmitted packet stream — no set-membership, no packet-count slack,
no loss factor. The host tail's standalone throughput is measured and
reported (host_stage_msamples_per_s) to prove the host stages sustain
the device rate, so the e2e number is bounded by upload bytes/s alone.

Input is packed 4-bit IQ (frontend.pack_cs4, 1 byte/sample) — at the
5 dB operating point 4-bit quantization costs ~0 extra LDPC trials
(tests/test_carrier_bank.py).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
plus secondary fields: streamed e2e rate, host-stage rate, sustained
ingest MB/s, the 8PSK 3/4 + pilots bank rate, the GSE->GRE gate, and
the DVB-S device-resident streaming-bank rate (dvbs_* fields, vs
REFBENCH viterbi_12_synced).

Baseline denominator: measured from the reference's own code compiled
headless at -O3 -march=native (tools/bench_reference.py -> REFBENCH.json,
BASELINE.md "Reference measured"): the equal-output-quality 8-carrier
aggregate bound on this host's 4-core Xeon is 4 cores x 15.35 Msamples/s
(coding stack only, all 16 SIMD lanes gated, zero front-end cost — strictly
generous to the reference) = 61.4 Msamples/s. vs_baseline is our aggregate
samples/s divided by that.
"""
import json
import sys
import time

import numpy as np

N_CARRIERS = 8
REF_AGGREGATE = 61.4e6          # 4 cores x 15.35 Msamples/s (BASELINE.md)
REF_DVBS_PER_CORE = 6.785e6     # REFBENCH viterbi_12_synced


def contiguous_packets(got: bytes, sent: np.ndarray, label: str) -> int:
    """got must be one byte-exact contiguous run of sent's packets
    (the interop standard, test_interop.py:344-351)."""
    g = np.frombuffer(got, np.uint8)
    assert len(g) >= 188 and len(g) % 188 == 0, \
        f"{label}: no/ragged TS output ({len(g)} B)"
    gp = g.reshape(-1, 188)
    i0 = sent.tobytes().find(gp[0].tobytes())
    assert i0 >= 0 and i0 % 188 == 0, f"{label}: first packet not in TX"
    k0 = i0 // 188
    assert k0 + len(gp) <= len(sent), f"{label}: output beyond TX tail"
    assert np.array_equal(gp, sent[k0:k0 + len(gp)]), \
        f"{label}: output is not a contiguous run of the TX packets"
    return len(gp)


def s2_carrier_signal(cfg, n_pkts, seed, cfo, delay, payload="ts",
                      snr_db=5.0):
    """Distinct continuous impaired stream + its TX packet record."""
    from dvbs_tpu.tx import dvbs2_mod, gse_mod, channel
    if payload == "ts":
        pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
        bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
        sent = pkts.reshape(-1, 188)
    else:
        rng = np.random.default_rng(seed)
        pdus = [rng.integers(1, 256, 300 + 13 * i).astype(np.uint8).tobytes()
                for i in range(n_pkts)]
        gp = []
        for i, p in enumerate(pdus):
            if i % 3 == 0 and len(p) > 400:
                gp += gse_mod.gse_packets_fragmented(p, frag_id=i % 8,
                                                     chunk=220)
            else:
                gp.append(gse_mod.gse_packet_unfrag(p))
        bb = gse_mod.gse_to_bbframes(gp, cfg.kbch)
        sent = pdus
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=snr_db, cfo=cfo, delay_samples=delay,
                       sco_ppm=10.0, seed=seed + 1)
    return y, sent


def time_step(jax, step, dev_in, sync_key, reps=10, hints=None,
              batches=3):
    """Per-call ms of a jitted device step (async dispatch, one sync).

    Takes the MINIMUM over `batches` rep-batches."""
    o = step(dev_in) if hints is None else step(dev_in, hints)
    np.asarray(jax.device_get(o[sync_key]))
    best = float("inf")
    for _ in range(batches):
        t0 = time.time()
        for _ in range(reps):
            o = step(dev_in) if hints is None else step(dev_in, hints)
        np.asarray(jax.device_get(o[sync_key]))
        best = min(best, (time.time() - t0) / reps * 1e3)
    return best


def bench_dvbs(jax, jnp):
    """DVB-S via the production streaming bank (DVBSBankStream):
    contiguous per-carrier TS across >= 3 block seams, then the
    device-resident steady-state step rate. Returns (msps, ms, host_msps)."""
    from dvbs_tpu.parallel.dvbs_bank import DVBSBankStream
    from dvbs_tpu.io.native import NativeDVBSTail
    from dvbs_tpu.tx import dvbs_mod, channel
    from dvbs_tpu.ops import frontend

    # 2^18 symbols (2^19 samples) per carrier per block
    n = 2 * (1 << 18)
    blocks = 5
    need = (blocks + 1) * n
    # enough DISTINCT TS groups to cover `need` without tiling the
    # ENCODED symbols: tiling tx repeats the encoder/interleaver
    # start-up transient at every tile seam — a genuinely discontinuous
    # stream the receiver rightly resyncs on (it cost round 4's 2^18
    # config its gate; shorter blocks simply never crossed a seam)
    # samples per framed byte: 8 coded-frame bits x 1 sym/bit x 2 sps /
    # ... = 16; a group is 8 x 204 = 1632 framed bytes
    n_groups = -(-need // (16 * 1632)) + 2
    sigs, sents = [], []
    for c in range(N_CARRIERS):
        ts = dvbs_mod.random_ts_groups(n_groups, seed=40 + c)
        mod = dvbs_mod.DVBSModulator(rate="1/2")
        tx = mod.ts_to_symbols(ts)
        x = channel.shape(tx, sps=2)
        y = channel.impair(x, snr_db=8.0, cfo=(0.004 + 0.002 * c) * np.pi,
                           delay_samples=0.2 + 0.1 * c, sco_ppm=10.0,
                           seed=50 + c)
        assert len(y) >= need, (len(y), need)
        sigs.append(frontend.pack_cs4(y[:need]))
        sents.append(ts.reshape(-1, 188))

    st = DVBSBankStream(N_CARRIERS, rate="1/2", block_samples=n,
                        ingest="cs4")
    outs = [bytearray() for _ in range(N_CARRIERS)]
    for lo in range(0, need, n):
        for c, o in zip(st.feed([s[lo:lo + n] for s in sigs]), outs):
            o.extend(c)
    assert st.locked.all() and (st.ber < 0.05).all(), \
        f"DVB-S bank must stay locked: ber={st.ber}"
    npkts = [contiguous_packets(bytes(outs[c]), sents[c], f"dvbs c{c}")
             for c in range(N_CARRIERS)]
    assert min(npkts) >= 100

    # host-tail standalone rate (C++ deframe+deint+RS+descramble) on the
    # real decoded bits of the stream's final block
    dev_in = st.last_debug["dev_in"]
    hints = st.last_debug["hints"]
    bits = np.unpackbits(st.last_debug["out"]["bits"], axis=1)
    tails = [NativeDVBSTail() for _ in range(N_CARRIERS)]
    bits_c = [np.ascontiguousarray(bits[c]) for c in range(N_CARRIERS)]
    for c in range(N_CARRIERS):
        tails[c].feed(bits_c[c])
    t0 = time.time()
    host_reps = 5
    for _ in range(host_reps):
        for c in range(N_CARRIERS):
            tails[c].feed(bits_c[c])
    host_msps = N_CARRIERS * n * host_reps / (time.time() - t0) / 1e6

    # device-resident steady-state rate
    ms = time_step(jax, st.step, dev_in, "ber", reps=10, hints=hints)
    return N_CARRIERS * n / (ms * 1e-3) / 1e6, ms, host_msps


def bench_hiord_bank(jax, jnp, mc, snr_db, label, n_iters=12):
    """Higher-order-constellation bank on device (BASELINE config 3 and the
    16/32APSK coverage configs): fused pilots bank, contiguous TS gate.
    Returns (msps, ms)."""
    from dvbs_tpu.spec import modcod
    from dvbs_tpu.parallel.mesh import build_carrier_bank, bank_block_symbols
    from dvbs_tpu.io.native import NativeTSParser
    from dvbs_tpu.ops import frontend

    cfg = modcod.get_config(mc, short=False, pilots=True)
    BLOCK = bank_block_symbols(N_CARRIERS, mc=mc, short=False, pilots=True)
    n = 2 * BLOCK
    kb = cfg.kbch // 8
    sigs, sents = [], []
    for c in range(N_CARRIERS):
        y, sent = s2_carrier_signal(cfg, 700, 110 + 3 * c,
                                    (0.006 + 0.002 * c) * np.pi,
                                    0.25 + 0.1 * c, snr_db=snr_db)
        assert len(y) >= n
        sigs.append(frontend.pack_cs4(y[:n]))
        sents.append(sent)
    samples = np.stack(sigs)
    step, _ = build_carrier_bank(N_CARRIERS, mc=mc, short=False,
                                 pilots=True, block_symbols=BLOCK,
                                 ingest="cs4", n_iters=n_iters)
    out = step(jnp.asarray(samples))
    h = {k: np.asarray(jax.device_get(v)) for k, v in out.items()}
    assert h["ldpc_ok"].all(), \
        f"{label} pilots bank must decode: {h['ldpc_ok'].sum()}/128"
    assert not h["bch_bad"].any()
    F = h["quality"].shape[1]
    kbb = np.ascontiguousarray(h["kbch_bytes"].reshape(N_CARRIERS, F, kb))
    for c in range(N_CARRIERS):
        got = NativeTSParser(cfg.kbch).feed(kbb[c])
        contiguous_packets(got, sents[c], f"{label} c{c}")
    dev_in = jax.device_put(jnp.asarray(samples))
    ms = time_step(jax, step, dev_in, "ldpc_ok", reps=10)
    return N_CARRIERS * n / (ms * 1e-3) / 1e6, ms


def main():
    """Fail-open reporting: every config runs inside a gate; a red gate
    records {name}_ok: false + reason in the JSON line instead of killing
    the run (one secondary assert once cost a whole run its metrics
    artifact). The single JSON line is
    ALWAYS printed; the exit code is only a summary bit."""
    import traceback

    results = {}
    failures = []

    def gate(name, fn):
        try:
            fn()
            return True
        except Exception as e:   # noqa: BLE001 — fail-open by design
            failures.append(name)
            results[f"{name}_ok"] = False
            results[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]
            traceback.print_exc(file=sys.stderr)
            return False

    try:
        _bench_all(results, gate)
    except Exception as e:       # noqa: BLE001 — even setup failure reports
        failures.append("setup")
        results["setup_ok"] = False
        results["setup_error"] = f"{type(e).__name__}: {e}"[:300]
        traceback.print_exc(file=sys.stderr)

    results.setdefault("metric", "dvbs2_qpsk12_8carrier_device_throughput")
    results.setdefault("value", None)
    results.setdefault("unit", "Msamples/s")
    results["all_gates_green"] = not failures
    if failures:
        results["failed_gates"] = failures
    print(json.dumps(results))
    return 0 if not failures else 1


def _bench_all(results, gate):
    from dvbs_tpu import compile_cache
    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    jnp.arange(8.0).sum().block_until_ready()   # warm the device claim

    from dvbs_tpu.spec import modcod
    from dvbs_tpu.parallel.mesh import bank_block_symbols
    from dvbs_tpu.models.bank_stream import DVBS2BankStream
    from dvbs_tpu.io import native as io_native
    assert io_native.available(), "run `make -C native` first"
    from dvbs_tpu.io.native import NativeTSParser
    from dvbs_tpu.ops import frontend

    mc, short = 4, False          # QPSK 1/2, normal frames (B4)
    cfg = modcod.get_config(mc, short=short)
    # block sized so the bank's 8 carriers yield exactly 128 frames
    # (bank_block_symbols, the benchmark geometry)
    BLOCK = bank_block_symbols(N_CARRIERS, mc=mc, short=short)
    n = 2 * BLOCK
    kb = cfg.kbch // 8
    F = None

    # continuous impaired stream per carrier at the realistic operating
    # point (5 dB: a few LDPC trials per frame) — DISTINCT signals
    # (independent payload/CFO/delay), long enough for the streamed e2e
    # loop to cross >= 4 block seams with look-ahead dispatch
    E2E_BLOCKS = 4
    sigs, sents = [], []
    for c in range(N_CARRIERS):
        y, sent = s2_carrier_signal(cfg, 2000, 10 + 3 * c,
                                    (0.008 + 0.002 * c) * np.pi,
                                    0.2 + 0.1 * c)
        sigs.append(frontend.pack_cs4(y))
        sents.append(sent)
    slen = min(len(s) for s in sigs)
    sigs = [s[:slen] for s in sigs]
    print(f"signals: {slen} samples/carrier", file=sys.stderr)

    # the production bank stream — its fused program is the headline
    # step AND the e2e engine AND (shared) the GSE gate's program
    st = DVBS2BankStream(N_CARRIERS, mc=mc, short=short,
                         block_symbols=BLOCK, ingest="cs4")
    step = st.step_fn
    F = st.F

    # ---- HEADLINE: device-resident block rate (input already on device) —
    # the pure compute rate a PCIe/DMA-ingest deployment sustains
    shared = {}

    def g_headline():
        samples0 = np.stack([s[:n] for s in sigs])
        dev_in = jax.device_put(jnp.asarray(samples0))
        out = step(dev_in)
        ok = np.asarray(jax.device_get(out["ldpc_ok"]))
        assert ok.all(), f"bench signal must decode cleanly ({ok.sum()}/128)"
        assert not np.asarray(jax.device_get(out["bch_bad"])).any()
        dev_ms = time_step(jax, step, dev_in, "ldpc_ok", reps=10)
        dev_msps = N_CARRIERS * n / (dev_ms * 1e-3) / 1e6
        shared["out"] = out
        results["value"] = round(dev_msps, 2)
        results["vs_baseline"] = round(dev_msps * 1e6 / REF_AGGREGATE, 4)
        results["device_block_ms"] = round(dev_ms, 2)

    def g_host_stage():
        # host-stage standalone throughput (native C++ TS parse):
        # proves the host tail sustains (far exceeds) the device rate
        kbb0 = np.ascontiguousarray(np.asarray(jax.device_get(
            shared["out"]["kbch_bytes"])).reshape(N_CARRIERS, F, kb))
        parsers = [NativeTSParser(cfg.kbch) for _ in range(N_CARRIERS)]
        for c in range(N_CARRIERS):
            parsers[c].feed(kbb0[c])
        t0 = time.time()
        host_reps = 20
        for _ in range(host_reps):
            for c in range(N_CARRIERS):
                parsers[c].feed(kbb0[c])
        host_msps = N_CARRIERS * n * host_reps / (time.time() - t0) / 1e6
        results["host_stage_msamples_per_s"] = round(host_msps, 1)

    def g_e2e():
        # DVBS2BankStream streaming the continuous signals (pre-packed
        # cs4 chunks), strict contiguous TS per carrier
        st_e2e = DVBS2BankStream(N_CARRIERS, mc=mc, short=short,
                                 block_symbols=BLOCK,
                                 ingest="cs4", program=st.program)
        # slack: the damped advance re-centers the frame grid toward the
        # block margin, consuming up to ~a frame-length of extra samples
        # over the run — without it the last block starves by a hair
        need = (n + E2E_BLOCKS * 2 * (F * cfg.plframe_len)
                + 2 * cfg.plframe_len)
        assert slen >= need, (slen, need)
        chunk = n // 2
        outs = [bytearray() for _ in range(N_CARRIERS)]
        fed = 0
        t0 = time.time()
        while fed < need:
            e = min(fed + chunk, need)
            for c, o in zip(st_e2e.feed([s[fed:e] for s in sigs]), outs):
                o.extend(c)
            fed = e
        for c, o in zip(st_e2e.flush(), outs):
            o.extend(c)
        dt = time.time() - t0
        e2e_msps = N_CARRIERS * fed / dt / 1e6
        assert (st_e2e.frames_ok == st_e2e.frames_seen).all(), \
            f"e2e frames lost: {st_e2e.frames_ok} of {st_e2e.frames_seen}"
        for c in range(N_CARRIERS):
            npk = contiguous_packets(bytes(outs[c]), sents[c], f"e2e c{c}")
            want = (E2E_BLOCKS + 1) * F * (kb // 188) - 2
            assert npk >= want, f"e2e c{c}: {npk} pkts < {want}"
        results["e2e_ts_msamples_per_s"] = round(e2e_msps, 4)
        results["e2e_vs_baseline"] = round(e2e_msps * 1e6 / REF_AGGREGATE, 4)
        # cs4: 1 B/sample
        results["ingest_mb_per_s_sustained"] = round(e2e_msps, 1)

    def g_gse():
        # GSE -> GRE gate through the SAME compiled program
        gse_sigs, gse_pdus = [], []
        for c in range(N_CARRIERS):
            y, pdus = s2_carrier_signal(cfg, 30, 210 + 3 * c,
                                        (0.006 + 0.002 * c) * np.pi,
                                        0.3 + 0.07 * c, payload="gse",
                                        snr_db=6.0)
            reps = -(-int(1.6 * n) // len(y))
            gse_sigs.append(frontend.pack_cs4(np.tile(y, reps))[:2 * n])
            gse_pdus.append(pdus)
        st_gse = DVBS2BankStream(N_CARRIERS, mc=mc, short=short,
                                 block_symbols=BLOCK,
                                 ingest="cs4", program=st.program)
        gouts = st_gse.feed(gse_sigs)
        for c, extra in enumerate(st_gse.flush()):
            gouts[c] = gouts[c] + extra
        gse_found = 0
        for c in range(N_CARRIERS):
            blob = bytes(gouts[c])
            gse_found += sum(1 for p in gse_pdus[c]
                             if (b"\x00\x00\x08\x00" + p) in blob)
        gse_total = sum(len(p) for p in gse_pdus)
        results["gse_gre_pdus_ok"] = f"{gse_found}/{gse_total}"
        assert gse_found >= gse_total - N_CARRIERS * 2, \
            f"GSE: only {gse_found}/{gse_total} PDUs recovered"

    def g_8psk():
        msps, ms = bench_hiord_bank(jax, jnp, 14, 9.5, "8psk34")
        results["s2_8psk34_pilots_device_msamples_per_s"] = round(msps, 2)
        results["s2_8psk34_pilots_block_ms"] = round(ms, 2)

    def g_16apsk():
        msps, ms = bench_hiord_bank(jax, jnp, 18, 11.0, "16apsk23")
        results["s2_16apsk23_pilots_device_msamples_per_s"] = round(msps, 2)

    def g_32apsk():
        # 32APSK 3/4 at 14.5 dB (~1.5 dB over ideal threshold, under cs4
        # 4-bit quantization) at the standard 12-sweep budget: the
        # round-4 trials tail was the flat-clamped pilot-anchor tail
        # integrating residual CFO (fixed in plphase.pilot_anchor_phases)
        # — post-fix trials run ~6 mean at
        # the worst bench corner, so the 25-sweep band-aid is retired
        msps, ms = bench_hiord_bank(jax, jnp, 24, 14.5, "32apsk34")
        results["s2_32apsk34_pilots_device_msamples_per_s"] = round(msps, 2)

    def g_dvbs():
        # DVB-S streaming bank (REFBENCH viterbi_12_synced per-core bar)
        msps, ms, host_msps = bench_dvbs(jax, jnp)
        results["dvbs_device_msamples_per_s"] = round(msps, 2)
        results["dvbs_block_ms"] = round(ms, 2)
        results["dvbs_vs_ref_core"] = round(msps * 1e6 / REF_DVBS_PER_CORE,
                                            3)
        results["dvbs_host_stage_msamples_per_s"] = round(host_msps, 1)

    if gate("headline", g_headline):
        gate("host_stage", g_host_stage)
    gate("e2e", g_e2e)
    gate("gse", g_gse)
    gate("s2_8psk34", g_8psk)
    gate("s2_16apsk23", g_16apsk)
    gate("s2_32apsk34", g_32apsk)
    gate("dvbs", g_dvbs)

    results["metric"] = "dvbs2_qpsk12_8carrier_device_throughput"
    results["unit"] = "Msamples/s"
    results["ingest"] = ("cs4 (1 B/sample); gates = contiguous "
                         "byte-exact TS/GRE per carrier")


if __name__ == "__main__":
    sys.exit(main())
