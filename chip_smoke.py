#!/usr/bin/env python3
"""Smoke run of the receiver's main path on one NVIDIA GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the carrier-sharded
                                     # bank vs the same bank on one card

Phases (one JAX process, all on the card; any failure exits non-zero
before the last line):

1. refuse unless JAX's first device is a GPU; print the card's name and
   power limit (nvidia-smi);
2. build native/ (the C++ host tail) from its sources;
3. DVB-S2 bank at full width: 8 carriers, QPSK 1/2 normal frames, cs4
   ingest, the benchmark block (bank_block_symbols, 128 frames); distinct
   impaired signals at 5 dB streamed through >= 4 block seams — every
   carrier's TS is one byte-exact contiguous run of its sent packets and
   every frame decodes; cold first call, compile-cache reuse and the warm
   per-block device time;
4. DVB-S bank: 8 carriers, rate 1/2, 2^19 samples per carrier per block,
   >= 3 seams, locked with contiguous byte-exact TS;
5. the CLI (dvbs_tpu.cli.main) on captures written by tools/make_capture
   for --mode s2 and --mode s, output files byte-exact against the TS;
6. card-versus-CPU checks of the translated and re-routed stages at
   bench widths: LDPC and Viterbi hard bits bit for bit, matched filter
   and resampler within a stated relative error, PLS indices and frame
   starts exactly;
7. one JSON line: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_CARRIERS = 8
E2E_BLOCKS = 4           # S2 bank blocks after the first: 4 seams
DVBS_BLOCKS = 5          # DVB-S blocks: 4 seams
TIMED_STEPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(jax, fn, n=TIMED_STEPS) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# ---------------------------------------------------------------------------
# signals (numpy only; generated in spawned CPU-only worker processes)
# ---------------------------------------------------------------------------

def _s2_signal(c: int):
    from bench import s2_carrier_signal
    from dvbs_tpu.spec import modcod
    from dvbs_tpu.ops.frontend import pack_cs4
    cfg = modcod.get_config(4, short=False)
    y, sent = s2_carrier_signal(cfg, 2000, 10 + 3 * c,
                                (0.008 + 0.002 * c) * np.pi, 0.2 + 0.1 * c)
    return pack_cs4(y), sent


def _dvbs_signal(args):
    c, need = args
    from dvbs_tpu.tx import dvbs_mod, channel
    from dvbs_tpu.ops.frontend import pack_cs4
    n_groups = -(-need // (16 * 1632)) + 2
    ts = dvbs_mod.random_ts_groups(n_groups, seed=40 + c)
    tx = dvbs_mod.DVBSModulator(rate="1/2").ts_to_symbols(ts)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=8.0,
                       cfo=(0.004 + 0.002 * c) * np.pi,
                       delay_samples=0.2 + 0.1 * c, sco_ppm=10.0,
                       seed=50 + c)
    assert len(y) >= need, (len(y), need)
    return pack_cs4(y[:need]), ts.reshape(-1, 188)


def generate(fn, args):
    """Map fn over args in CPU-only worker processes (the card stays
    with this process alone); the pool is shut down on return."""
    import concurrent.futures
    import multiprocessing
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(fn, args))
    finally:
        if saved is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = saved


def s2_geometry():
    from dvbs_tpu.spec import modcod
    from dvbs_tpu.parallel.mesh import bank_block_symbols
    cfg = modcod.get_config(4, short=False)
    return cfg, bank_block_symbols(N_CARRIERS, mc=4, short=False)


def stream_s2(st, sigs, need, chunk):
    outs = [bytearray() for _ in range(N_CARRIERS)]
    fed = 0
    while fed < need:
        e = min(fed + chunk, need)
        for c, o in zip(st.feed([s[fed:e] for s in sigs]), outs):
            o.extend(c)
        fed = e
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    return [bytes(o) for o in outs]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_native():
    subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                   stdout=subprocess.DEVNULL)
    from dvbs_tpu.io import native as io_native
    assert io_native.available(), "native/ did not build"
    log("native: built native/libdvbs_native.so")


def phase_s2_bank(jax, jnp, cache_events):
    from bench import contiguous_packets
    from dvbs_tpu.models.bank_stream import DVBS2BankStream
    cfg, block = s2_geometry()
    n = 2 * block
    t0 = time.perf_counter()
    sigs, sents = zip(*generate(_s2_signal, range(N_CARRIERS)))
    slen = min(len(s) for s in sigs)
    log(f"s2 bank: signals {N_CARRIERS} x {slen} samples "
        f"({time.perf_counter() - t0:.1f} s)")

    st = DVBS2BankStream(N_CARRIERS, mc=4, short=False, block_symbols=block,
                         ingest="cs4")
    x0 = jnp.asarray(np.stack([s[:n] for s in sigs]))
    # first call twice, the second after dropping the in-memory caches:
    # it must come back from the persistent compilation cache. Both
    # calls come from this one line — the Triton kernel's IR carries the
    # caller's source location, which is part of the cache key.
    first, hits = [], []
    for rep in range(2):
        if rep:
            jax.clear_caches()
        h0 = cache_events["hits"]
        t0 = time.perf_counter()
        out = jax.block_until_ready(st.step_fn(x0))
        first.append(time.perf_counter() - t0)
        hits.append(cache_events["hits"] - h0)
    ok = np.asarray(out["ldpc_ok"])
    assert ok.all() and not np.asarray(out["bch_bad"]).any(), \
        f"s2 bank block must decode cleanly ({int(ok.sum())}/{ok.size})"
    ms = median_ms(jax, lambda: st.step_fn(x0))
    log(f"s2 bank: {N_CARRIERS} carriers x {block} symbols = "
        f"{N_CARRIERS * n} samples/block, {ok.size} frames; first call "
        f"{first[0]:.1f} s; warm block {ms:.3f} ms (median of "
        f"{TIMED_STEPS} steps)")
    log(f"compile cache: first call {first[0]:.1f} s ({hits[0]} "
        f"persistent-cache hits), again after clearing in-memory caches "
        f"{first[1]:.1f} s ({hits[1]} hits); second call "
        f"{'hit' if hits[1] else 'MISSED'} the cache")

    st_e2e = DVBS2BankStream(N_CARRIERS, mc=4, short=False,
                             block_symbols=block, ingest="cs4",
                             program=st.program)
    F = st_e2e.F
    need = n + E2E_BLOCKS * 2 * (F * cfg.plframe_len) + 2 * cfg.plframe_len
    assert slen >= need, (slen, need)
    outs = stream_s2(st_e2e, sigs, need, n // 2)
    assert (st_e2e.frames_ok == st_e2e.frames_seen).all(), \
        f"s2 frames lost: {st_e2e.frames_ok} of {st_e2e.frames_seen}"
    kb = cfg.kbch // 8
    want = (E2E_BLOCKS + 1) * F * (kb // 188) - 2
    npk = [contiguous_packets(outs[c], sents[c], f"s2 c{c}")
           for c in range(N_CARRIERS)]
    assert min(npk) >= want, (npk, want)
    log(f"s2 bank: {E2E_BLOCKS} seams, frames ok {st_e2e.frames_ok.tolist()}"
        f" of {st_e2e.frames_seen.tolist()}, contiguous TS packets {npk}")
    return dict(sigs=sigs, x0=x0, llrs=out["llrs"], block=block, cfg=cfg)


def phase_dvbs_bank(jax, jnp):
    from bench import contiguous_packets
    from dvbs_tpu.parallel.dvbs_bank import DVBSBankStream
    n = 1 << 19
    need = (DVBS_BLOCKS + 1) * n
    t0 = time.perf_counter()
    sigs, sents = zip(*generate(_dvbs_signal,
                                [(c, need) for c in range(N_CARRIERS)]))
    log(f"dvbs bank: signals {N_CARRIERS} x {need} samples "
        f"({time.perf_counter() - t0:.1f} s)")
    st = DVBSBankStream(N_CARRIERS, rate="1/2", block_samples=n,
                        ingest="cs4")
    outs = [bytearray() for _ in range(N_CARRIERS)]
    t0 = time.perf_counter()
    first = None
    for lo in range(0, need, n):
        for c, o in zip(st.feed([s[lo:lo + n] for s in sigs]), outs):
            o.extend(c)
        if first is None:
            first = time.perf_counter() - t0
    assert st.locked.all() and (st.ber < 0.05).all(), \
        f"dvbs bank must stay locked: ber={st.ber}"
    npk = [contiguous_packets(bytes(outs[c]), sents[c], f"dvbs c{c}")
           for c in range(N_CARRIERS)]
    assert min(npk) >= 100, npk
    dev_in, hints = st.last_debug["dev_in"], st.last_debug["hints"]
    ms = median_ms(jax, lambda: st.step(dev_in, hints))
    log(f"dvbs bank: {N_CARRIERS} carriers x {n} samples/block; first "
        f"block (lock + compile) {first:.1f} s; {DVBS_BLOCKS} seams, "
        f"locked, contiguous TS packets {npk}; warm block {ms:.3f} ms "
        f"(median of {TIMED_STEPS} steps)")


def phase_cli():
    from bench import contiguous_packets
    from dvbs_tpu import cli
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_capture
    with tempfile.TemporaryDirectory() as tmp:
        for mode, cap_args, rx_args in (
                ("s2", ["--modcod", "4", "--framesize", "short",
                        "--packets", "600", "--snr", "6", "--cfo", "0.02",
                        "--sco-ppm", "10", "--delay", "0.3"],
                 ["--modcod", "4", "--framesize", "short",
                  "--block-symbols", str(1 << 15)]),
                ("s", ["--rate", "1/2", "--groups", "60", "--snr", "9",
                       "--cfo", "0.01", "--delay", "0.3"],
                 ["--rate", "1/2", "--block-symbols", str(1 << 15)])):
            iq = os.path.join(tmp, f"{mode}.cf32")
            ts = os.path.join(tmp, f"{mode}.ts")
            out = os.path.join(tmp, f"{mode}.out.ts")
            assert make_capture.main(["--mode", mode, *cap_args,
                                      "--out", iq, "--ts", ts]) == 0
            assert cli.main(["--iq", iq, "--mode", mode, *rx_args,
                             "--out", out]) == 0
            sent = np.fromfile(ts, np.uint8).reshape(-1, 188)
            got = open(out, "rb").read()
            npk = contiguous_packets(got, sent, f"cli {mode}")
            assert npk >= len(sent) // 2, (npk, len(sent))
            log(f"cli --mode {mode}: {npk} of {len(sent)} TS packets, "
                f"one contiguous byte-exact run")


def phase_kernel_checks(jax, jnp, s2):
    """Card vs CPU for every translated or re-routed stage at bench
    widths. Tolerances: LDPC/Viterbi hard bits, PLS indices and frame
    starts exactly; matched filter and resampler max |gpu - cpu| /
    rms(cpu) <= 1e-4 — both run the same f32 (matched filter: bf16
    operands, whose products are exact in f32) arithmetic, so they
    differ only in f32 summation order and fused multiply-adds, a few
    ulp (~1e-6 relative) per output."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_ldpc_pallas import int_golden
    from dvbs_tpu.models.dvbs2 import DVBS2Receiver
    from dvbs_tpu.ops import frontend, ldpc_pallas, viterbi
    from dvbs_tpu.spec import dvbs_fec
    cpu = jax.devices("cpu")[0]
    cfg, block = s2["cfg"], s2["block"]

    # LDPC: the kernel on the bank block's own 128 frames (fixed sweeps)
    q = ldpc_pallas.quantize_llrs(s2["llrs"])
    hard, _, _ = ldpc_pallas.decode_qc_pallas(q, cfg.ldpc_table, n_iters=2,
                                              early_exit=False)
    hard = np.asarray(hard)
    ref = int_golden(np.asarray(q), cfg.ldpc_table, n_iters=2)
    assert np.array_equal(hard, ref), \
        f"ldpc: {int((hard != ref).sum())} bits differ from the int golden"
    x = q
    ms_k = median_ms(jax, lambda: ldpc_pallas.decode_qc_pallas(
        x, cfg.ldpc_table, n_iters=12))
    log(f"check ldpc: kernel == numpy int golden bit for bit on "
        f"{hard.shape[0]} x {hard.shape[1]} bits (2 sweeps); 12-sweep "
        f"early-exit decode {ms_k:.3f} ms (median of {TIMED_STEPS})")

    # Viterbi: the bank's segment shape [8 carriers x 512, 704, 2]
    rng = np.random.default_rng(7)
    nseg, T = N_CARRIERS * 512, 512 + 2 * 96
    bits = rng.integers(0, 2, nseg * T).astype(np.uint8)
    xy = dvbs_fec.cc_encode(bits).reshape(nseg, T, 2).astype(np.float32)
    llr = (1.0 - 2.0 * xy) + rng.normal(0, 0.7, xy.shape).astype(np.float32)
    vg = np.asarray(viterbi.decode_segments(jnp.asarray(llr)))
    with jax.default_device(cpu):
        vc = np.asarray(viterbi.decode_segments(llr))
    assert np.array_equal(vg, vc), \
        f"viterbi: {int((vg != vc).sum())} bits differ gpu vs cpu"
    xd = jnp.asarray(llr)
    ms_v = median_ms(jax, lambda: viterbi.decode_segments(xd))
    nsteps = -(-T // 4)
    log(f"check viterbi: gpu == cpu bit for bit on {nseg} x {T} segments; "
        f"{ms_v:.3f} ms per call, {nsteps} radix-16 scan steps = "
        f"{ms_v / nsteps * 1e3:.2f} us/step")

    # matched filter and resampler on one carrier of the bank block
    ri = np.asarray(frontend.unpack_cs4(jnp.asarray(s2["sigs"][0][:2 * block])))
    xs = (ri[0].astype(np.float32) + 1j * ri[1].astype(np.float32))
    xs = (xs / np.sqrt(np.mean(np.abs(xs) ** 2))).astype(np.complex64)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b)) / np.sqrt(np.mean(np.abs(b) ** 2)))

    mf = jax.jit(frontend.matched_filter)
    with jax.default_device(cpu):
        y_c = np.asarray(mf(xs))
    e_mf = rel(mf(jnp.asarray(xs)), y_c)
    k = np.arange(block, dtype=np.float32)
    t = np.clip(2.0 * k + 0.37 + 4e-5 * k, 0.0, 2 * block - 1.0)
    rs = jax.jit(frontend.resample_windowed)
    with jax.default_device(cpu):
        z_c = np.asarray(rs(y_c, t))
    e_rs = rel(rs(jnp.asarray(y_c), jnp.asarray(t)), z_c)
    assert e_mf <= 1e-4 and e_rs <= 1e-4, (e_mf, e_rs)
    ym = jnp.asarray(y_c)
    tm = jnp.asarray(t)
    ms_r = median_ms(jax, lambda: rs(ym, tm))
    log(f"check frontend: matched filter max rel err {e_mf:.2e}, "
        f"resampler max rel err {e_rs:.2e} (tolerance 1e-4) on "
        f"{xs.size} samples; resampler {ms_r:.3f} ms per carrier")

    # PLS detection and frame location: the S2 core, card vs CPU
    rx = DVBS2Receiver(mc=4, short=False, block_symbols=block)
    ri16 = np.stack([xs.real, xs.imag]).astype(np.float16)
    og = rx._sym_fn(jnp.asarray(ri16))
    with jax.default_device(cpu):
        oc = rx._sym_fn(ri16)
    for k in ("pls", "starts"):
        a, b = np.asarray(og[k]), np.asarray(oc[k])
        assert np.array_equal(a, b), f"{k}: gpu {a} vs cpu {b}"
    assert (np.asarray(og["pls"]) == cfg.pls_code).all()
    log(f"check s2 core: PLS indices and frame starts equal on gpu and "
        f"cpu ({np.asarray(og['pls']).size} frames)")


def phase_sharded(jax, jnp):
    """8 carriers sharded 2 per card over a 1-D `carrier` mesh of 4
    cards vs the same 8 signals on one card: TS byte for byte."""
    from bench import contiguous_packets
    from dvbs_tpu.models.bank_stream import DVBS2BankStream
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from dvbs_tpu.parallel.mesh import build_carrier_bank_sharded
    assert len(jax.devices()) >= 4, jax.devices()
    cfg, block = s2_geometry()
    n = 2 * block
    sigs, sents = zip(*generate(_s2_signal, range(N_CARRIERS)))
    blocks = 2
    st1 = DVBS2BankStream(N_CARRIERS, mc=4, short=False, block_symbols=block,
                          ingest="cs4")
    program = build_carrier_bank_sharded(4, carriers_per_device=2, mc=4,
                                         short=False, block_symbols=block,
                                         ingest="cs4")
    st4 = DVBS2BankStream(N_CARRIERS, mc=4, short=False, block_symbols=block,
                          ingest="cs4", program=program)
    need = n + blocks * 2 * (st1.F * cfg.plframe_len) + 2 * cfg.plframe_len
    t0 = time.perf_counter()
    out1 = stream_s2(st1, sigs, need, n // 2)
    t1 = time.perf_counter()
    out4 = stream_s2(st4, sigs, need, n // 2)
    t4 = time.perf_counter()
    for st, label in ((st1, "1 card"), (st4, "4 cards")):
        assert (st.frames_ok == st.frames_seen).all(), \
            f"{label}: frames lost {st.frames_ok} of {st.frames_seen}"
    npk = [contiguous_packets(out4[c], sents[c], f"sharded c{c}")
           for c in range(N_CARRIERS)]
    same = [out1[c] == out4[c] for c in range(N_CARRIERS)]
    assert all(same), f"sharded TS differs from one-card TS: {same}"
    log(f"sharded bank: 8 carriers, 2 per card on a 4-card `carrier` mesh; "
        f"{blocks} seams; TS equal to the one-card bank byte for byte on "
        f"every carrier ({npk} packets); stream wall time one card "
        f"{t1 - t0:.1f} s, four cards {t4 - t1:.1f} s (compile included)")
    x = np.stack([s[:n] for s in sigs])
    x1 = jax.device_put(x, jax.devices()[0])
    x4 = jax.device_put(x, NamedSharding(Mesh(np.array(jax.devices()[:4]),
                                              ("carrier",)), P("carrier")))
    ms1 = median_ms(jax, lambda: st1.step_fn(x1))
    ms4 = median_ms(jax, lambda: st4.step_fn(x4))
    log(f"sharded bank: warm block one card {ms1:.3f} ms, four cards "
        f"{ms4:.3f} ms (median of {TIMED_STEPS} steps, input on device)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the carrier-sharded bank on four "
                         "cards and compare it with one card")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)

    sys.path.insert(0, REPO)
    from dvbs_tpu import compile_cache
    cache_dir = compile_cache.enable()
    n_cached = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    log(f"compile cache: {cache_dir} ({n_cached} entries at start)")
    cache_events = {"hits": 0}

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            cache_events["hits"] += 1
    jax.monitoring.register_event_listener(on_event)
    import jax.numpy as jnp

    phase_native()
    if args.cards == 4:
        phase_sharded(jax, jnp)
    else:
        s2 = phase_s2_bank(jax, jnp, cache_events)
        phase_dvbs_bank(jax, jnp)
        phase_cli()
        phase_kernel_checks(jax, jnp, s2)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
