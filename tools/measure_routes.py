#!/usr/bin/env python3
"""Measure, on one GPU, the LDPC route decision and the re-routed stages.

    python tools/measure_routes.py                # both variants below
    python tools/measure_routes.py --stages-only  # base, kernel route only
    python tools/measure_routes.py --out DIR      # where files go

The parent stays off JAX and runs each variant in a child process of its
own, one after the other (one JAX process on the card at a time):

- base: the fused 8-carrier DVB-S2 bank step (QPSK 1/2 normal frames,
  the bench block of 128 frames, cs4 ingest, 5 dB signals) with the LDPC
  kernel route and with XLA decode_qc over all 128 frames in one call,
  timed in turns (kernel, xla, xla, kernel); a profiler trace of the
  kernel-route step (device time by kernel, and by the `resample` and
  `ldpc` name scopes, read from the compiled program's op metadata); the
  8-carrier resampler alone at the step's shapes; the Viterbi scan at the
  DVB-S bank's segment shape;
- cmdbuf: the decode_qc form again, with XLA_FLAGS adding WHILE and
  CONDITIONAL command buffers (--xla_gpu_enable_command_buffer).

Every result line is JSON; the summary and the trace digest go to
--out (default <checkout>/measure_out).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMDBUF_FLAGS = ("--xla_gpu_enable_command_buffer=FUSION,CUBLAS,CUBLASLT,"
                "CUSTOM_CALL,CUDNN,WHILE,CONDITIONAL "
                "--xla_gpu_graph_min_graph_size=1")
N_CARRIERS = 8
REPS = 10


def median_ms(jax, fn, n=REPS):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def emit(d):
    print(json.dumps(d), flush=True)


def bank_input(jnp):
    from bench import s2_carrier_signal
    from dvbs_tpu.ops.frontend import pack_cs4
    from dvbs_tpu.parallel.mesh import bank_block_symbols
    from dvbs_tpu.spec import modcod
    cfg = modcod.get_config(4, short=False)
    block = bank_block_symbols(N_CARRIERS, mc=4, short=False)
    n = 2 * block
    sigs = []
    for c in range(N_CARRIERS):
        y, _ = s2_carrier_signal(cfg, 450, 10 + 3 * c,
                                 (0.008 + 0.002 * c) * np.pi, 0.2 + 0.1 * c)
        assert len(y) >= n, (len(y), n)
        sigs.append(pack_cs4(y[:n]))
    return block, jnp.asarray(np.stack(sigs))


def build_step(jax, route, block, x):
    """The fused bank step with the GPU LDPC route set to `route`
    (traced on the first call, so the route is read then)."""
    from dvbs_tpu.ops import routes
    from dvbs_tpu.parallel.mesh import build_carrier_bank
    routes.ROUTES["ldpc"]["gpu"] = route
    step, _ = build_carrier_bank(N_CARRIERS, mc=4, short=False,
                                 block_symbols=block, ingest="cs4")
    t0 = time.perf_counter()
    out = jax.block_until_ready(step(x))
    first = time.perf_counter() - t0
    ok = np.asarray(out["ldpc_ok"])
    bch_bad = np.asarray(out["bch_bad"])
    emit(dict(variant=route, first_call_s=first, frames=int(ok.size),
              ldpc_ok=int(ok.sum()), bch_bad=int(bch_bad.sum()),
              trials_mean=float(np.asarray(out["trials"]).mean())))
    return step


def kernel_scopes(hlo_text: str) -> dict:
    """Kernel name (as the trace shows it) -> the op_name metadata of the
    HLO instruction it runs, from a compiled program's text."""
    import re
    scopes = {}
    for m in re.finditer(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?"
                         r'metadata=\{[^}]*op_name="([^"]*)"', hlo_text,
                         re.M):
        scopes[m.group(1).replace(".", "_")] = m.group(2)
    return scopes


def trace_summary(jax, fn, tag, out, scopes=None):
    """Device time by kernel name in a 3-step profiler trace, and by name
    scope (`scopes` maps kernel names to their op metadata)."""
    import glob
    import tempfile
    from jax.profiler import ProfileData
    scopes = scopes or {}
    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(3):
                jax.block_until_ready(fn())
        path = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                         recursive=True)[0]
        prof = ProfileData.from_file(path)
        by_name, scoped, busy = {}, {}, 0.0
        lines = []
        sample = None
        for plane in prof.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                lines.append(f"{plane.name} | {line.name}")
                if "XLA Ops" not in line.name and "Kernel" not in \
                        line.name and "Stream" not in line.name:
                    continue
                for ev in line.events:
                    dur = ev.duration_ns / 1e6
                    by_name[ev.name] = by_name.get(ev.name, 0.0) + dur
                    busy += dur
                    st = ev.stats
                    items = st.items() if hasattr(st, "items") else st
                    stats = " ".join(f"{k}={v}" for k, v in items)
                    if sample is None:
                        sample = f"{ev.name}: {stats[:600]}"
                    meta = stats + " " + scopes.get(ev.name, "")
                    for scope in ("resample", "ldpc", "viterbi"):
                        if scope in meta:
                            key = f"{line.name}:{scope}"
                            scoped[key] = scoped.get(key, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:40]
    with open(os.path.join(out, f"trace_{tag}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\nsample event: " + str(sample) +
                "\n\n" + "\n".join(f"{ms / 3:10.3f} ms/step  {name}"
                                   for name, ms in top) + "\n")
    emit(dict(trace=tag, steps=3, scoped_ms_per_step={
        k: v / 3 for k, v in scoped.items()},
        summed_event_ms_per_step=busy / 3,
        top5=[(n[:80], ms / 3) for n, ms in top[:5]]))


def child(variant: str, out: str):
    sys.path.insert(0, REPO)
    from dvbs_tpu import compile_cache
    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    assert jax.devices()[0].platform == "gpu", jax.devices()
    block, x = bank_input(jnp)
    emit(dict(variant=variant, xla_flags=os.environ.get("XLA_FLAGS", ""),
              block_symbols=block, samples_per_block=int(x.size)))
    if variant == "cmdbuf":
        step = build_step(jax, "xla", block, x)
        emit(dict(variant="xla+cmdbuf",
                  ms=[median_ms(jax, lambda: step(x)) for _ in range(2)]))
        return
    routes_run = ("triton",) if variant == "stages" else ("triton", "xla")
    steps = {r: build_step(jax, r, block, x) for r in routes_run}
    times = {r: [] for r in routes_run}
    for r in routes_run + routes_run[::-1]:
        times[r].append(median_ms(jax, lambda: steps[r](x)))
    emit(dict(variant="turns", order=",".join(routes_run + routes_run[::-1]),
              ms=times, reps=REPS))
    try:
        scopes = kernel_scopes(steps["triton"].lower(x).compile().as_text())
        trace_summary(jax, lambda: steps["triton"](x), "bank_triton", out,
                      scopes)
    except Exception as e:  # noqa: BLE001 - the timings below still run
        emit(dict(trace="bank_triton", error=f"{type(e).__name__}: {e}"))

    # the resampler alone at the step's shapes (8 carriers, vmapped)
    from dvbs_tpu.ops import frontend, viterbi
    n = 2 * block
    rng = np.random.default_rng(0)
    y2 = (rng.normal(size=(N_CARRIERS, n)) +
          1j * rng.normal(size=(N_CARRIERS, n))).astype(np.complex64)
    k = np.arange(block, dtype=np.float32)
    t = np.clip(2.0 * k + 0.37 + 4e-5 * k, 0, n - 1)
    t = np.broadcast_to(t, (N_CARRIERS, block)).copy()
    rs = jax.jit(jax.vmap(frontend.resample_windowed))
    y2d, td = jnp.asarray(y2), jnp.asarray(t)
    emit(dict(stage="resample", carriers=N_CARRIERS, symbols=block,
              ms=median_ms(jax, lambda: rs(y2d, td))))

    # the Viterbi scan at the DVB-S bank's segment shape
    nseg, T = N_CARRIERS * 512, 512 + 2 * 96
    llr = jnp.asarray(rng.normal(size=(nseg, T, 2)).astype(np.float32))
    ms = median_ms(jax, lambda: viterbi.decode_segments(llr))
    nsteps = -(-T // 4)
    emit(dict(stage="viterbi", segments=nseg, steps=nsteps, ms=ms,
              us_per_step=ms / nsteps * 1e3))


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages-only", action="store_true",
                    help="the kernel route's stage times only")
    ap.add_argument("--out", default=os.path.join(REPO, "measure_out"),
                    help="directory for routes.json and the trace digest")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    if args.child:
        child(args.child, out)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    results = {"card": smi}
    variants = ("stages",) if args.stages_only else ("base", "cmdbuf")
    for variant in variants:
        env = dict(os.environ)
        if variant == "cmdbuf":
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " +
                                CMDBUF_FLAGS).strip()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", variant, "--out", out], env=env,
                           capture_output=True, text=True)
        lines = [json.loads(x) for x in p.stdout.splitlines()
                 if x.startswith("{")]
        for x in lines:
            print(json.dumps(x), flush=True)
        results[variant] = dict(rc=p.returncode, lines=lines,
                                stderr_tail=p.stderr[-3000:])
        if p.returncode:
            print(p.stderr[-3000:], file=sys.stderr, flush=True)
    with open(os.path.join(out, "routes.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
