"""Channel-parallel demodulation over a device mesh.

The reference runs one single-threaded plugin instance per carrier
(max instances fixed, main.cpp:30). Here a bank of N carriers is sharded
over a 1-D `carrier` mesh axis with shard_map: each device demodulates
its local carriers (vmapped single-carrier block program) and the lock
metrics are aggregated across the mesh with a psum — SURVEY.md sec.
2.5's "data parallelism over carriers".
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..spec import modcod
from ..models.dvbs2 import DVBS2Receiver


def build_multi_carrier(n_devices: int, carriers_per_device: int = 1,
                        mc: int = 4, short: bool = True,
                        block_symbols: int = 1 << 15):
    """Build a jitted multi-carrier demod step over an n_devices mesh.

    Returns (step_fn, example_input, mesh). step_fn maps
    [C, 2, n_samples] float32 -> dict of per-carrier outputs plus the
    mesh-aggregated lock count ("locked", shape [1]).
    """
    devices = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devices, ("carrier",))
    rx = DVBS2Receiver(mc=mc, short=short, block_symbols=block_symbols)
    core = rx._sym_fn
    fec = rx._fec2_fn or rx._fec_fn     # full trial budget (no host
                                        # escalation inside shard_map)
    C = n_devices * carriers_per_device
    n = 2 * block_symbols

    def local_step(samples_ri):          # [C/D, 2, n]
        out = jax.vmap(core)(samples_ri)
        llrs = out.pop("llrs")           # [c, F, N]: decode all lanes at once
        c, F, N = llrs.shape
        fd = fec(llrs.reshape(c * F, N))
        ok = fd["ldpc_ok"].reshape(c, F)
        locked = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), "carrier")
        return dict(hard=fd["hard"].reshape(c, F, N),
                    trials=fd["trials"].reshape(c, F),
                    ldpc_ok=ok, quality=out["quality"],
                    pls=out["pls"], locked=jnp.reshape(locked, (1,)))

    step = jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=(P("carrier", None, None),),
        out_specs=dict(hard=P("carrier"), trials=P("carrier"),
                       ldpc_ok=P("carrier"), quality=P("carrier"),
                       pls=P("carrier"), locked=P()),
    ))
    example = np.zeros((C, 2, n), np.float16)
    return step, example, mesh


def bank_block_symbols(n_carriers: int = 8, mc: int = 4,
                       short: bool = False, pilots: bool = False,
                       frames_total: int = 128) -> int:
    """Smallest per-carrier block that brings the bank's frame total to
    `frames_total` WITHOUT exceeding it (when n_carriers doesn't divide
    frames_total the total rounds DOWN). 128 frames is the benchmark
    geometry: about one frame per streaming multiprocessor of the card
    for the per-frame LDPC kernel (ops/ldpc_pallas)."""
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    per = max(1, frames_total // n_carriers)
    raw = (per + 1) * cfg.plframe_len + 2 * 256 + 90
    # round up to a multiple of 64 (timing-recovery window divisibility)
    return -(-raw // 64) * 64


def _bank_fec(rx, interpret: bool, keep_hard: bool):
    """LDPC (routes.ldpc_decode) + on-device BCH syndromes + packing of
    the BB-descrambled kbch bytes (a fixed byte-mask XOR,
    bbframe_descramble.cpp:122-143), so the host tail goes straight to
    the TS/GSE parser and the output fetch is 8x smaller than bits."""
    from ..ops import bch, frontend, routes
    from ..spec import scrambling
    cfg = rx.cfg
    bb_mask = scrambling.bb_scrambler_byte_mask(cfg.kbch // 8)

    def fec(llrs, n_iters):
        hard, n_bad, trials = routes.ldpc_decode(
            llrs, cfg.ldpc_table, n_iters, interpret=interpret)
        bch_bad = bch.syndrome_nonzero(hard[:, :cfg.nbch], cfg.framesize,
                                       cfg.rate)
        packed = frontend.pack_bits_to_bytes(hard[:, :cfg.kbch]) ^ bb_mask
        # trials = per-frame sweep at which the decoder's syndrome first
        # read zero (n_iters if never) — the reference's trials-used-or-
        # max metric (bbframe_ldpc.cpp:123-139)
        d = dict(kbch_bytes=packed, trials=trials, ldpc_ok=n_bad == 0,
                 bch_bad=bch_bad)
        if keep_hard:
            d["hard"] = hard
        return d
    return fec


def build_carrier_bank(n_carriers: int, mc: int = 4, short: bool = False,
                       pilots: bool = False,
                       block_symbols: int = 1 << 17, n_iters: int = 12,
                       ingest: str = "cs8", interpret: bool = False,
                       stream_outputs: bool = False,
                       n_iters_full: int = 32):
    """Single-device multi-carrier bank: the whole bank (front end, FEC,
    BCH syndromes, byte packing) demodulates in ONE device program per
    block (vmap over the carrier axis) — the BASELINE.json 8-carrier
    aggregate configuration on one card.

    Input is int8 IQ ([C, 2, n], the native cs8 SDR capture format; the
    on-device AGC renormalizes). ingest="cs4" instead takes packed 4-bit
    IQ ([C, n] uint8, see frontend.pack_cs4) — 1 byte/sample at ~0
    sensitivity cost at the 5 dB operating point; the nibbles are
    sign-extended on device.

    The LDPC decoder is the route of the platform the program is lowered
    for (ops/routes.py); interpret=True runs the GPU kernel in Pallas
    interpret mode instead (CPU tests).

    Returns (step_fn, example_input): step(samples [C, 2, n]) ->
    dict(kbch_bytes [C*F, kbch/8] uint8, trials [C*F], ldpc_ok [C*F],
    bch_bad [C*F], quality [C, F], pls [C, F], pls_conf [C, F]).

    stream_outputs=True adds the fields the streaming driver
    (models/bank_stream.DVBS2BankStream) needs: starts [C, F] (located
    frame starts, for cross-block boundary continuity), cfo [C]
    (applied coarse CFO), freq [C, F], hard [C*F, nldpc] (device-resident
    hard bits — only BCH-flagged rows are ever fetched for host repair)
    and llrs [C*F, nldpc] (device-resident, for the rare full-budget
    escalation rerun) — and the return becomes (step_fn, example,
    escalate_fn) where escalate_fn(llrs) reruns the whole lane set at
    the full `n_iters_full` trial budget (the host-level analogue of
    the reference's bad()-gated retry, layered_decoder.hh:121-133).
    """
    if ingest not in ("cs8", "cs4"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    from ..ops import frontend
    rx = DVBS2Receiver(mc=mc, short=short, pilots=pilots,
                       block_symbols=block_symbols,
                       max_ldpc_trials=n_iters)
    core = rx._sym_fn
    total = n_carriers * rx.n_frames
    N = rx.cfg.nldpc
    fec = _bank_fec(rx, interpret, keep_hard=stream_outputs)

    @jax.jit
    def step(samples):
        if ingest == "cs4":
            samples = frontend.unpack_cs4(samples)
        out = jax.vmap(core)(samples)
        llrs = out.pop("llrs").reshape(total, N)
        fd = fec(llrs, n_iters)
        fd.update(quality=out["quality"], pls=out["pls"],
                  pls_conf=out["pls_conf"])
        if stream_outputs:
            fd.update(starts=out["starts"], cfo=out["cfo"],
                      freq=out["freq"], llrs=llrs)
        return fd

    if ingest == "cs4":
        example = np.zeros((n_carriers, 2 * block_symbols), np.uint8)
    else:
        example = np.zeros((n_carriers, 2, 2 * block_symbols), np.int8)
    if stream_outputs:
        return step, example, jax.jit(lambda llrs: fec(llrs, n_iters_full))
    return step, example


def build_carrier_bank_sharded(n_devices: int, carriers_per_device: int = 1,
                               mc: int = 4, short: bool = False,
                               pilots: bool = False,
                               block_symbols: int | None = None,
                               n_iters: int = 12,
                               n_iters_full: int = 32,
                               ingest: str = "cs8"):
    """Mesh-sharded bank program with DVBS2BankStream's output contract.

    The production streaming driver (models/bank_stream.DVBS2BankStream)
    takes any (step, example, escalate) triple via its `program=`
    parameter; this builds one whose step is a shard_map over a
    `carrier` device mesh — each device demodulates and FEC-decodes its
    local carriers, and the driver's host tail (escalation gating, BCH
    repair, per-carrier TS parse, damped-advance continuity) runs
    unchanged on the gathered outputs. This is the multi-chip scale
    story of SURVEY.md sec. 2.5 applied to the STREAMING receiver, not
    just a one-shot block demod (cf. build_multi_carrier).

    Each shard decodes its local lanes on the LDPC route of the
    platform (ops/routes.py). Returns (step, example, escalate).
    """
    devices = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devices, ("carrier",))
    if block_symbols is None:
        block_symbols = bank_block_symbols(
            n_devices * carriers_per_device, mc=mc, short=short,
            pilots=pilots)
    rx = DVBS2Receiver(mc=mc, short=short, pilots=pilots,
                       block_symbols=block_symbols,
                       max_ldpc_trials=n_iters)
    core = rx._sym_fn
    F = rx.n_frames
    N = rx.cfg.nldpc
    cl = carriers_per_device
    C = n_devices * cl
    n = 2 * block_symbols

    from ..ops import frontend
    fec = _bank_fec(rx, interpret=False, keep_hard=True)

    def unpack(p):
        return frontend.unpack_cs4(p) if ingest == "cs4" else p

    def local_step(samples):
        out = jax.vmap(core)(unpack(samples))
        llrs = out.pop("llrs").reshape(cl * F, N)
        fd = fec(llrs, n_iters)
        fd.update(quality=out["quality"], pls=out["pls"],
                  pls_conf=out["pls_conf"],
                  starts=out["starts"], cfo=out["cfo"],
                  freq=out["freq"], llrs=llrs)
        return fd

    lane_specs = dict(kbch_bytes=P("carrier"), trials=P("carrier"),
                      ldpc_ok=P("carrier"), bch_bad=P("carrier"),
                      hard=P("carrier"), llrs=P("carrier"))
    step = jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=(P("carrier"),),
        out_specs=dict(quality=P("carrier"), pls=P("carrier"),
                       pls_conf=P("carrier"),
                       starts=P("carrier"), cfo=P("carrier"),
                       freq=P("carrier"), **lane_specs),
    ))

    def local_esc(llrs):
        return fec(llrs, n_iters_full)

    escalate = jax.jit(shard_map(
        local_esc, mesh=mesh, in_specs=(P("carrier"),),
        out_specs=lane_specs))

    if ingest == "cs4":
        example = np.zeros((C, n), np.uint8)
    else:
        example = np.zeros((C, 2, n), np.int8)
    return step, example, escalate
