#!/usr/bin/env python3
"""Multi-host DCN dryrun: the carrier bank over jax.distributed.

Validates BASELINE.md config 5 ("8-carrier bank on N>=2 hosts") without
real multi-host hardware: N_HOSTS separate processes each own
DEV_PER_HOST virtual CPU devices, join a jax.distributed coordinator,
and run the shard_map carrier-bank step over the GLOBAL 1-D carrier
mesh — per-carrier distinct signals, per-carrier decode asserted, and
the cross-host psum'd lock count checked on every host.

Run: python tools/dryrun_multihost.py            (spawns the workers)
     python tools/dryrun_multihost.py --worker I (one host process)
"""
import os
import subprocess
import sys

N_HOSTS = 2
DEV_PER_HOST = 4
COORD = "127.0.0.1:9911"


def worker(pid: int) -> None:
    # env (JAX_PLATFORMS etc.) must come from the spawning process: the
    # site customization imports jax before this code runs
    import jax
    jax.distributed.initialize(coordinator_address=COORD,
                               num_processes=N_HOSTS, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

    assert jax.process_count() == N_HOSTS
    assert len(jax.devices()) == N_HOSTS * DEV_PER_HOST

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dvbs_tpu.parallel.mesh import build_multi_carrier
    from dvbs_tpu.tx import dvbs2_mod, channel
    from dvbs_tpu.spec import modcod

    C = N_HOSTS * DEV_PER_HOST
    step, example, mesh = build_multi_carrier(
        C, carriers_per_device=1, mc=4, short=True, block_symbols=1 << 15)

    # per-carrier distinct signals (same construction as
    # __graft_entry__.dryrun_multichip) — every host generates the full
    # bank deterministically, then contributes only its local shards
    cfg = modcod.get_config(4, short=True)
    n = example.shape[-1]
    samples = np.zeros(example.shape, np.float32)
    for c in range(C):
        pkts = dvbs2_mod.random_ts_packets(160, seed=300 + c)
        bbf = dvbs2_mod.ts_to_bbframes(pkts, cfg)
        txs = dvbs2_mod.bbframes_to_plframes(bbf, cfg).reshape(-1)
        x = channel.shape(txs, sps=2)
        y = channel.impair(x, snr_db=7.0 + 0.4 * c,
                           cfo=(0.002 + 0.002 * c) * np.pi,
                           delay_samples=0.13 * c, seed=c)
        samples[c] = np.stack([y[:n].real, y[:n].imag])

    sh = NamedSharding(mesh, P("carrier", None, None))
    garr = jax.make_array_from_callback(
        samples.shape, sh, lambda idx: samples[idx])
    out = step(garr)

    # "locked" is psum'd across the mesh — replicated, so every host can
    # read it; per-carrier flags are fetched via allgather
    from jax.experimental import multihost_utils
    locked = int(np.asarray(jax.device_get(out["locked"]))[0])
    ok = multihost_utils.process_allgather(out["ldpc_ok"],
                                           tiled=True)       # [C, F]
    ok = np.asarray(ok).reshape(C, -1)
    n_frames = ok.size
    assert locked == n_frames, f"host {pid}: {locked}/{n_frames} locked"
    per_carrier = ok.all(axis=1)
    assert per_carrier.all(), \
        f"host {pid}: carriers failed: {np.nonzero(~per_carrier)[0].tolist()}"
    print(f"host {pid}: {locked}/{n_frames} frames decoded across "
          f"{jax.process_count()} hosts x {DEV_PER_HOST} devices",
          flush=True)

    # ---- phase 2: the 2D {carrier, time} grid (BASELINE config 5's
    # full shape: carriers x time-blocks x hosts). The device grid is
    # laid out so consecutive TIME shards live on ALTERNATING hosts —
    # every halo ppermute hop crosses the DCN boundary, which is the
    # thing this dryrun exists to validate.
    from dvbs_tpu.parallel.timeshard import build_grid_sharded
    C2, T2 = 2, N_HOSTS * DEV_PER_HOST // 2
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    grid = np.empty((C2, T2), object)
    for c in range(C2):
        for t in range(T2):
            host = t % N_HOSTS                  # alternate hosts along time
            slot = c * (T2 // N_HOSTS) + t // N_HOSTS
            grid[c, t] = devs[host * DEV_PER_HOST + slot]
    gstep, gexample, gmesh, A2 = build_grid_sharded(
        C2, T2, mc=4, short=True, block_symbols=1 << 15, devices=grid)

    cfg2 = modcod.get_config(4, short=True)
    gsig = np.zeros(gexample.shape, np.float32)
    gbbs = []
    for c in range(C2):
        pkts = dvbs2_mod.random_ts_packets(90, seed=500 + c)
        bbf = dvbs2_mod.ts_to_bbframes(pkts, cfg2)
        txs = dvbs2_mod.bbframes_to_plframes(bbf, cfg2).reshape(-1)
        x = channel.shape(txs, sps=2)
        y = channel.impair(x, snr_db=8.0, cfo=(0.003 + 0.002 * c) * np.pi,
                           delay_samples=0.21 * c, seed=510 + c)
        assert len(y) >= T2 * A2
        for t in range(T2):
            seg = y[t * A2:(t + 1) * A2]
            gsig[c, t] = np.stack([seg.real, seg.imag])
        gbbs.append({fr.tobytes() for fr in bbf})
    gsh = NamedSharding(gmesh, P("carrier", "time", None, None))
    garr2 = jax.make_array_from_callback(gsig.shape, gsh,
                                         lambda idx: gsig[idx])
    gout = gstep(garr2)
    gok = np.asarray(multihost_utils.process_allgather(
        gout["ldpc_ok"], tiled=True)).reshape(C2, T2, -1)
    ghard = np.asarray(multihost_utils.process_allgather(
        gout["hard"], tiled=True))
    ghard = ghard.reshape(C2, T2, gok.shape[-1], -1)
    # all wrap-free shards decode, and each carrier decodes ITS OWN
    # stream (frames must come from that carrier's transmitted set)
    for c in range(C2):
        assert gok[c, :-1].all(), f"grid carrier {c}: {gok[c]}"
        for t in range(T2 - 1):
            for f in range(gok.shape[-1]):
                fb = np.packbits(ghard[c, t, f, :cfg2.kbch]).tobytes()
                assert fb in gbbs[c], \
                    f"grid carrier {c} shard {t} frame {f}: foreign frame"
    print(f"host {pid}: 2D grid {C2}x{T2} ok "
          f"({gok[:, :-1].sum()} frames, time ring crosses hosts)",
          flush=True)
    jax.distributed.shutdown()


def main() -> int:
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{DEV_PER_HOST}")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--worker", str(i)], env=env)
             for i in range(N_HOSTS)]
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        print(f"FAILED: worker exit codes {rcs}", file=sys.stderr)
        return 1
    print(f"dryrun_multihost: OK ({N_HOSTS} hosts x {DEV_PER_HOST} devices)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
