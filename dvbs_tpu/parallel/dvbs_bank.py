"""Multi-carrier DVB-S bank: the locked Viterbi chain for N carriers
fused into ONE device program per block.

The DVB-S analogue of parallel/mesh.build_carrier_bank: the reference
runs one single-threaded plugin instance per carrier (max instances
fixed, main.cpp:30) whose SYNCED steady state is the volk ACS kernel
chain (viterbi_all.cpp:209-273, cc_decoder.cpp:56-92); here the bank's
front ends are vmapped and every carrier's Viterbi segments decode in
one batched lax.scan (ops/viterbi.py), so the per-step ACS work is
N_carriers*segments wide.

Acquisition stays on host: the first step() call runs the existing
per-carrier lock search (models/dvbs.DVBSReceiver._try_lock) on the
front-end output, then compiles the steady-state bank with each
carrier's (rotation, depuncture-alignment) baked in — the same
acquire-once-then-SYNCED lifecycle as the reference, and what its
measured viterbi_12_synced baseline times (REFBENCH.json).

Each block is demodulated with first-block semantics (fresh coarse CFO
/ timing / V&V estimates — every estimator is feed-forward, so there
is no warm-up penalty); streaming state continuity across blocks lives
in models/dvbs.DVBSStream, which shares the same device chain.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import dvbs_fec
from ..ops import frontend, plphase, viterbi

TEST_BITS = 2048
BER_THRESHOLD = 0.15


def _front_first(ri):
    """First-block front end for one carrier: int8/float re+im [2, n] ->
    serialized (I, Q) soft symbols [n] float32 (mirrors the hints=first
    path of models/dvbs.DVBSReceiver._build_front)."""
    s = (ri[0].astype(jnp.float32) +
         1j * ri[1].astype(jnp.float32)).astype(jnp.complex64)
    x = frontend.agc(s)
    cfo = frontend.coarse_cfo_estimate(x)
    x = frontend.mix(x, cfo)
    y = frontend.matched_filter(x)
    z, _ = frontend.recover_symbols(y, n_windows=16)
    f4 = frontend.qpsk_residual_freq(z)
    S = z.shape[-1]
    z = z * jnp.exp(-1j * f4 * jnp.arange(S)).astype(z.dtype)
    ph = plphase.qpsk_vv_track(z[None, :], jnp.zeros(1))[0]
    zc = z * jnp.exp(-1j * ph).astype(z.dtype)
    return jnp.stack([jnp.real(zc), jnp.imag(zc)], axis=1).reshape(-1)


_front_first_jit = jax.jit(_front_first)   # shared (relock must not retrace)


def unpack_cs4_host(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of frontend.pack_cs4 (for the lock pass)."""
    hi = ((packed.astype(np.int16) >> 4) ^ 8) - 8
    lo = ((packed.astype(np.int16) & 15) ^ 8) - 8
    return (hi + 1j * lo).astype(np.complex64)


def build_dvbs_bank(n_carriers: int, rate: str = "1/2",
                    block_samples: int = 1 << 17, core: int = 512,
                    wing: int = 96, ingest: str = "cs4"):
    """Returns (step, example). step(samples) -> dict(bits [C, nb] uint8
    packed decoded bits, ber [C] float32 re-encode BER, n_pairs int).

    samples: [C, n] uint8 packed cs4 IQ (ingest="cs4") or [C, 2, n]
    float16 re/im (ingest="f16"). The first call locks each carrier on
    host (rotation x alignment hypothesis search) and compiles the
    steady-state program; subsequent calls are one fused device step.
    """
    if ingest not in ("cs4", "f16"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    C, n = n_carriers, block_samples
    px, py = dvbs_fec.PUNCTURE[rate]
    p = len(px)
    pat = np.stack([px, py], axis=1).reshape(-1).astype(bool)
    n_kept = int(pat.sum())
    pat_idx = np.nonzero(pat)[0]
    # uniform stream length across carriers regardless of each one's
    # alignment drop (drops are < 2*n_kept)
    max_drop = 2 * n_kept
    n_use = (n - max_drop) // n_kept * n_kept
    periods = n_use // n_kept
    n_pairs = periods * p
    B = -(-n_pairs // core)
    TB = min(TEST_BITS, n_pairs)

    state = {"fn": None}

    def _lock(samples):
        """Host acquisition pass: run the front once for ALL carriers
        (one jitted program, not eager per-op dispatch), then
        search (rotation, drop) per carrier with the stock lock logic."""
        from ..models.dvbs import DVBSReceiver
        if ingest == "cs4":
            sc = np.stack([unpack_cs4_host(np.asarray(samples[c]))
                           for c in range(C)])
            ri = np.stack([sc.real, sc.imag], axis=1).astype(np.float32)
        else:
            ri = np.asarray(samples, np.float32)
        softs = np.asarray(jax.jit(jax.vmap(_front_first))(
            jnp.asarray(ri))).astype(np.float32)
        rots, drops = [], []
        for c in range(C):
            rx = DVBSReceiver(rate=rate, block_symbols=n // 2)
            rx._try_lock(softs[c])
            if not rx.locked:
                raise RuntimeError(f"carrier {c}: no Viterbi lock "
                                   f"(best BER {rx.ber:.3f})")
            rots.append(rx.rotation)
            drops.append(rx.drop)
        return np.array(rots), np.array(drops)

    def _build(rots, drops):
        @jax.jit
        def bank(samples):
            if ingest == "cs4":
                ri = frontend.unpack_cs4(samples)
            else:
                ri = samples
            soft = jax.vmap(_front_first)(ri)          # [C, n] serial
            dls = []
            for c in range(C):
                s = soft[c]
                if rots[c]:
                    pr = s.reshape(-1, 2)
                    s = jnp.stack([pr[:, 1], -pr[:, 0]], axis=1
                                  ).reshape(-1)
                s = jax.lax.slice(s, (int(drops[c]),),
                                  (int(drops[c]) + n_use,))
                used = s.reshape(periods, n_kept)
                dl2 = jnp.zeros((periods, 2 * p), jnp.float32)
                dl2 = dl2.at[:, pat_idx].set(used)   # static scatter
                dls.append(dl2.reshape(-1, 2))
            dl = jnp.stack(dls)                       # [C, n_pairs, 2]
            padded = jnp.zeros((C, B * core + 2 * wing, 2), jnp.float32)
            padded = padded.at[:, wing:wing + n_pairs].set(dl)
            segs = jnp.stack([jax.lax.slice(
                padded, (0, i * core, 0),
                (C, i * core + core + 2 * wing, 2))
                for i in range(B)], axis=1)           # [C, B, T, 2]
            bits_seg = viterbi.decode_segments(
                segs.reshape(C * B, core + 2 * wing, 2))
            bits = bits_seg.reshape(C, B, -1)[:, :, wing:wing + core] \
                .reshape(C, -1)[:, :n_pairs]
            # re-encode BER over the first TB pairs per carrier (the
            # SYNCED watchdog, viterbi_all.cpp:209-273)
            bp = jnp.concatenate(
                [jnp.zeros((C, 6), bits.dtype), bits[:, :TB]], axis=1)

            def enc(poly):
                acc = jnp.zeros((C, TB), jnp.int32)
                for j in range(7):
                    if (poly >> j) & 1:
                        acc = acc + bp[:, j:j + TB].astype(jnp.int32)
                return acc % 2
            exy = jnp.stack([enc(dvbs_fec.G1), enc(dvbs_fec.G2)], axis=2)
            chunk = dl[:, :TB]
            maskz = chunk != 0
            hard = (chunk < 0).astype(jnp.int32)
            nm = jnp.sum(maskz, axis=(1, 2))
            ber = jnp.sum(jnp.where(maskz, (exy != hard).astype(jnp.int32),
                                    0), axis=(1, 2)) / jnp.maximum(nm, 1)
            nb8 = -(-n_pairs // 8) * 8
            bits_p = jnp.concatenate(
                [bits, jnp.zeros((C, nb8 - n_pairs), bits.dtype)], axis=1)
            return dict(bits=frontend.pack_bits_to_bytes(bits_p),
                        ber=ber.astype(jnp.float32))
        return bank

    def step(samples):
        if state["fn"] is None:
            rots, drops = _lock(samples)
            state["fn"] = _build(rots, drops)
        out = dict(state["fn"](samples))
        out["n_pairs"] = n_pairs
        return out

    if ingest == "cs4":
        example = np.zeros((C, n), np.uint8)
    else:
        example = np.zeros((C, 2, n), np.float16)
    return step, example


# ---------------------------------------------------------------------------
# Streaming bank: continuity + watchdog (the production DVB-S path)
# ---------------------------------------------------------------------------

def _front_hinted(ri, hints, u_soft: int):
    """Hint-carrying front end for one carrier (the bank analogue of
    models/dvbs.DVBSReceiver._build_front): int8/float re+im [2, n] +
    hints [6] -> (soft [n] float32 serialized (I, Q), new_hints [6]).

    hints: [cfo, nco_phase, tau, theta, first, rot]. rot applies the
    locked 90-degree rotation as a DYNAMIC select so one compiled
    program serves every per-carrier rotation combination (a relock
    that flips a carrier's rotation costs no recompile).

    The stream advances u_soft SAMPLES per block (= u_soft/2 symbols =
    u_soft soft values), so the carried tau/theta are evaluated at that
    position, not at the block end — the overlap tail is re-demodulated
    by the next block.
    """
    first = hints[4] > 0.5
    s = (ri[0].astype(jnp.float32) +
         1j * ri[1].astype(jnp.float32)).astype(jnp.complex64)
    x = frontend.agc(s)
    cfo = jnp.where(first, frontend.coarse_cfo_estimate(x), hints[0])
    nco_phase = jnp.where(first, 0.0, hints[1])
    x = frontend.mix(x, cfo, nco_phase)
    y = frontend.matched_filter(x)
    z, _, tau_next = frontend.recover_symbols_full(
        y, n_windows=16, tau_hint=jnp.where(first, jnp.nan, hints[2]),
        tau_eval=u_soft)
    S = z.shape[-1]
    f4 = frontend.qpsk_residual_freq(z)
    z = z * jnp.exp(-1j * f4 * jnp.arange(S)).astype(z.dtype)
    theta0 = jnp.where(first, 0.0, hints[3])
    ph = plphase.qpsk_vv_track(z[None, :], theta0[None])[0]
    zc = z * jnp.exp(-1j * ph).astype(z.dtype)
    # locked rotation (z * exp(-j pi/2): I' = Q, Q' = -I), dynamic
    rot = hints[5] > 0.5
    zr = jnp.where(rot, jnp.imag(zc) - 1j * jnp.real(zc), zc)
    soft = jnp.stack([jnp.real(zr), jnp.imag(zr)], axis=1).reshape(-1)
    k_next = u_soft // 2            # symbol index where the next block starts
    new_hints = jnp.stack([
        cfo, nco_phase, tau_next,
        f4 * k_next + ph[k_next - 1],
        jnp.zeros(()), hints[5]])
    return soft, new_hints


def stream_bank_geometry(rate: str, block_samples: int, wing: int = 96,
                         front_margin: int = 512):
    """Soft-domain window geometry for seam-clean streaming.

    Every block decodes its whole soft window but emits only
    [ov_soft, ov_soft + u_soft): the emitted bits get >= `wing` pairs of
    REAL soft context on both sides (the left context is the previous
    block's re-demodulated tail, the right context is this block's
    overlap tail), so seam bits decode exactly like interior bits —
    unlike zero-padded block edges. front_margin additionally hides the
    matched-filter/timing-window edge transients inside the overlap.
    Units: 1 soft value = 1 sample (at 2 sps) = 1/2 symbol.
    """
    px, py = dvbs_fec.PUNCTURE[rate]
    p = len(px)
    n_kept = int(px.sum() + py.sum())
    chunk = n_kept * 2 // math.gcd(n_kept, 2)     # lcm: whole symbols
    ov_soft = -(-max(-(-wing // p) * n_kept, front_margin) // chunk) * chunk
    n_soft = block_samples                         # 2 * (n/2) symbols
    u_soft = (n_soft - 2 * ov_soft) // chunk * chunk
    assert u_soft > 0, "block too small for the overlap window"
    win_soft = u_soft + 2 * ov_soft
    pairs = dict(p=p, n_kept=n_kept,
                 ov=ov_soft // n_kept * p,
                 u=u_soft // n_kept * p,
                 win=win_soft // n_kept * p)
    return dict(chunk=chunk, ov_soft=ov_soft, u_soft=u_soft,
                win_soft=win_soft, pairs=pairs)


def build_dvbs_stream_bank(n_carriers: int, rate: str = "1/2",
                           block_samples: int = 1 << 17, core: int = 512,
                           wing: int = 96, ingest: str = "cs4"):
    """Steady-state streaming bank step: ONE device program, all
    carriers, hint continuity, dynamic rotation, overlap emission.

    Returns (step, example, geom). step(samples, hints [C, 6]) ->
    dict(bits [C, win_pairs/8] uint8 packed decoded bits of the WHOLE
    window (the host slices the emission range), ber [C] re-encode BER
    over the emitted head, hints [C, 6] next-block hints).
    """
    if ingest not in ("cs4", "f16"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    C, n = n_carriers, block_samples
    geom = stream_bank_geometry(rate, n, wing=wing)
    px, py = dvbs_fec.PUNCTURE[rate]
    p = len(px)
    pat = np.stack([px, py], axis=1).reshape(-1).astype(bool)
    n_kept = int(pat.sum())
    pat_idx = np.nonzero(pat)[0]
    win_soft = geom["win_soft"]
    periods = win_soft // n_kept
    n_pairs = periods * p
    ov_p, u_p = geom["pairs"]["ov"], geom["pairs"]["u"]
    B = -(-n_pairs // core)
    TB = min(TEST_BITS, u_p)

    @jax.jit
    def step(samples, hints):
        if ingest == "cs4":
            ri = frontend.unpack_cs4(samples)
        else:
            ri = samples
        soft, new_hints = jax.vmap(
            lambda r, h: _front_hinted(r, h, geom["u_soft"]))(ri, hints)
        used = soft[:, :win_soft].reshape(C, periods, n_kept)
        dl2 = jnp.zeros((C, periods, 2 * p), jnp.float32)
        dl2 = dl2.at[:, :, pat_idx].set(used)        # static scatter
        dl = dl2.reshape(C, -1, 2)                   # [C, n_pairs, 2]
        padded = jnp.zeros((C, B * core + 2 * wing, 2), jnp.float32)
        padded = padded.at[:, wing:wing + n_pairs].set(dl)
        segs = jnp.stack([jax.lax.slice(
            padded, (0, i * core, 0), (C, i * core + core + 2 * wing, 2))
            for i in range(B)], axis=1)
        bits_seg = viterbi.decode_segments(
            segs.reshape(C * B, core + 2 * wing, 2))
        bits = bits_seg.reshape(C, B, -1)[:, :, wing:wing + core] \
            .reshape(C, -1)[:, :n_pairs]
        # re-encode BER over the first TB pairs of the EMITTED window
        # (the SYNCED watchdog, viterbi_all.cpp:209-273)
        bp = jax.lax.slice(
            jnp.concatenate([jnp.zeros((C, 6), bits.dtype), bits], axis=1),
            (0, ov_p), (C, ov_p + 6 + TB))

        def enc(poly):
            acc = jnp.zeros((C, TB), jnp.int32)
            for j in range(7):
                if (poly >> j) & 1:
                    acc = acc + bp[:, j:j + TB].astype(jnp.int32)
            return acc % 2
        exy = jnp.stack([enc(dvbs_fec.G1), enc(dvbs_fec.G2)], axis=2)
        chunk = jax.lax.slice(dl, (0, ov_p, 0), (C, ov_p + TB, 2))
        maskz = chunk != 0
        hard = (chunk < 0).astype(jnp.int32)
        nm = jnp.sum(maskz, axis=(1, 2))
        ber = jnp.sum(jnp.where(maskz, (exy != hard).astype(jnp.int32), 0),
                      axis=(1, 2)) / jnp.maximum(nm, 1)
        nb8 = -(-n_pairs // 8) * 8
        bits_pad = jnp.concatenate(
            [bits, jnp.zeros((C, nb8 - n_pairs), bits.dtype)], axis=1)
        return dict(bits=frontend.pack_bits_to_bytes(bits_pad),
                    ber=ber.astype(jnp.float32), hints=new_hints)

    if ingest == "cs4":
        example = np.zeros((C, n), np.uint8)
    else:
        example = np.zeros((C, 2, n), np.float16)
    geom["n_pairs"] = n_pairs
    geom["emit"] = (ov_p, u_p)
    return step, example, geom


class DVBSBankStream:
    """Continuous N-carrier DVB-S demodulation, one device program.

    Lifecycle (per carrier, mirroring the reference's acquire-then-
    SYNCED plugin loop, viterbi_all.cpp:74-273): the first block runs
    the host lock search (rotation x depuncture alignment); the
    alignment drop folds into that carrier's FIFO advance (1 soft value
    = 1 sample at 2 sps) so the steady state is drop-free and
    rectangular across carriers; afterwards every block is ONE fused
    device step with hint continuity, and the per-carrier re-encode BER
    drives the reference's 20-strike relock watchdog — a struck carrier
    relocks from its own current samples without disturbing the rest of
    the bank (rotation is a dynamic hint: no recompile).
    """

    def __init__(self, n_carriers: int, rate: str = "1/2",
                 block_samples: int = 1 << 17, ingest: str = "f16",
                 native_tail: bool | None = None, core: int = 512):
        self.C = n_carriers
        self.rate = rate
        self.n = block_samples
        self.ingest = ingest
        self.step, _, self.geom = build_dvbs_stream_bank(
            n_carriers, rate=rate, block_samples=block_samples,
            core=core, ingest="cs4" if ingest == "cs4" else "f16")
        self._fifos = [np.zeros(0, np.complex64) for _ in range(n_carriers)]
        self._hints = np.zeros((n_carriers, 6), np.float32)
        self._hints[:, 4] = 1.0                     # first
        self._locked = np.zeros(n_carriers, bool)
        self._first_emit = np.ones(n_carriers, bool)
        self.out_of_sync = np.zeros(n_carriers, np.int32)
        self.ber = np.ones(n_carriers, np.float32)
        if native_tail is None:
            from ..io import native as io_native
            native_tail = io_native.available()
        self._native_tail = bool(native_tail)
        self._tails = [self._make_tail() for _ in range(n_carriers)]

    def _make_tail(self):
        if self._native_tail:
            from ..io.native import NativeDVBSTail
            return NativeDVBSTail()
        from ..models.dvbs import DVBSReceiver
        rx = DVBSReceiver(rate=self.rate, native_tail=False)
        return rx     # python tail container (used via _host_tail)

    def _tail_feed(self, c: int, bits: np.ndarray) -> bytes:
        if self._native_tail:
            return self._tails[c].feed(bits).reshape(-1).tobytes()
        res = self._tails[c]._host_tail(bits, None, 0)
        return res.ts_packets.reshape(-1).tobytes()

    # ------------------------------------------------------------------
    def _lock_carrier(self, c: int):
        """Host lock pass on carrier c's current FIFO head; folds the
        depuncture alignment into the FIFO and marks the carrier fresh."""
        from ..models.dvbs import DVBSReceiver
        y = self._fifos[c][:self.n]
        if y.dtype == np.uint8:                 # pre-packed cs4 stream
            y = unpack_cs4_host(y)
        rms = np.sqrt(np.mean(np.abs(y) ** 2)) + 1e-30
        ri = np.stack([y.real, y.imag]).astype(np.float32) / rms
        soft = np.asarray(_front_first_jit(jnp.asarray(ri))
                          ).astype(np.float32)
        rx = DVBSReceiver(rate=self.rate, block_symbols=self.n // 2)
        rx._try_lock(soft)
        if not rx.locked:
            self.ber[c] = rx.ber
            return False
        self._fifos[c] = self._fifos[c][rx.drop:]
        self._hints[c] = [0, 0, 0, 0, 1.0, float(rx.rotation)]
        self._locked[c] = True
        self._first_emit[c] = True
        self.out_of_sync[c] = 0
        self.ber[c] = rx.ber
        self._tails[c] = self._make_tail()
        return True

    def _upload(self, blocks: np.ndarray):
        if blocks.dtype == np.uint8:            # pre-packed cs4
            return jnp.asarray(blocks)
        if self.ingest == "cs4":
            return jnp.asarray(np.stack([frontend.pack_cs4(b)
                                         for b in blocks]))
        rms = np.sqrt(np.mean(np.abs(blocks) ** 2, axis=1,
                              keepdims=True)) + 1e-30
        bn = blocks / rms
        return jnp.asarray(np.stack([bn.real.astype(np.float16),
                                     bn.imag.astype(np.float16)], axis=1))

    # ------------------------------------------------------------------
    def feed(self, per_carrier) -> list[bytes]:
        for c in range(self.C):
            part = np.asarray(per_carrier[c])
            if part.dtype != np.uint8:          # pre-packed cs4 passthrough
                part = part.astype(np.complex64)
            if self._fifos[c].dtype != part.dtype:
                if len(self._fifos[c]):
                    raise TypeError(
                        f"carrier {c}: feed dtype switched to "
                        f"{part.dtype} with {len(self._fifos[c])} "
                        f"{self._fifos[c].dtype} samples buffered — "
                        "concatenating would silently corrupt the FIFO")
                self._fifos[c] = np.zeros(0, part.dtype)
            self._fifos[c] = np.concatenate([self._fifos[c], part])
        outs = [bytearray() for _ in range(self.C)]
        while all(len(f) >= self.n for f in self._fifos):
            for c in range(self.C):
                if not self._locked[c]:
                    self._lock_carrier(c)
            # a fresh lock folds its depuncture-alignment drop into the
            # FIFO (shrinking it by up to 2*n_kept samples) — re-check
            # every carrier still holds a full block before stacking
            if not all(len(f) >= self.n for f in self._fifos):
                break
            # unlocked carriers still ride the bank (their bits are
            # discarded); each may relock on a later block
            blocks = np.stack([f[:self.n] for f in self._fifos])
            dev_in = self._upload(blocks)
            hints_in = jnp.asarray(self._hints)
            out = self.step(dev_in, hints_in)
            out = {k: np.asarray(jax.device_get(v)) for k, v in out.items()}
            # self-consistent (input, hints, output) of the latest block —
            # bench.py re-times the step and re-feeds the host tail with it
            self.last_debug = dict(dev_in=dev_in, hints=hints_in, out=out)
            new_hints = out["hints"]
            ber = out["ber"]
            ov_p, u_p = self.geom["emit"]
            bits_all = np.unpackbits(out["bits"], axis=1)
            for c in range(self.C):
                adv = self.geom["u_soft"]
                if self._locked[c]:
                    # watchdog (reference 20-strike rule)
                    self.ber[c] = float(ber[c])
                    if ber[c] > BER_THRESHOLD:
                        self.out_of_sync[c] += 1
                        if self.out_of_sync[c] > 20:
                            self._locked[c] = False
                            self._hints[c, 4] = 1.0
                    else:
                        self.out_of_sync[c] = 0
                        lo = 0 if self._first_emit[c] else ov_p
                        outs[c].extend(self._tail_feed(
                            c, np.ascontiguousarray(
                                bits_all[c, lo:ov_p + u_p])))
                        self._first_emit[c] = False
                    # fold whole-sample timing drift into the advance
                    # (models/dvbs.DVBSReceiver._update_hints)
                    old_nco = float(self._hints[c, 1])
                    h = new_hints[c].copy()
                    tau = float(h[2])
                    adv = self.geom["u_soft"] - int(round(2.0 * tau))
                    h[2] = tau - round(2.0 * tau) / 2.0
                    h[1] = (old_nco + h[0] * adv) % (2 * np.pi)
                    self._hints[c] = h
                self._fifos[c] = self._fifos[c][adv:]
        return [bytes(o) for o in outs]

    # ------------------------------------------------------------------
    @property
    def locked(self) -> np.ndarray:
        return self._locked.copy()

    def get_state(self) -> dict:
        tails = [t.get_state() for t in self._tails]
        return dict(rate=self.rate,
                    fifos=[f.copy() for f in self._fifos],
                    hints=self._hints.copy(),
                    locked=self._locked.copy(),
                    first_emit=self._first_emit.copy(),
                    out_of_sync=self.out_of_sync.copy(),
                    ber=self.ber.copy(),
                    tails=tails)

    def set_state(self, st: dict):
        assert st["rate"] == self.rate
        self._fifos = [np.asarray(f, np.complex64).copy()
                       for f in st["fifos"]]
        self._hints = np.asarray(st["hints"], np.float32).copy()
        self._locked = np.asarray(st["locked"], bool).copy()
        self._first_emit = np.asarray(st["first_emit"], bool).copy()
        self.out_of_sync = np.asarray(st["out_of_sync"], np.int32).copy()
        self.ber = np.asarray(st["ber"], np.float32).copy()
        self._tails = [self._make_tail() for _ in range(self.C)]
        for t, ts in zip(self._tails, st["tails"]):
            t.set_state(ts)
