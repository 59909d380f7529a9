"""DVB-S receiver: feed-forward front end + auto-locking Viterbi chain.

Device counterpart of the reference's DVBSDemod
(/root/reference/src/demod/dvbs/module_dvbs_demod.cpp:78-117):

  samples (2 sps) -> AGC -> coarse CFO -> matched RRC
  -> feed-forward timing -> V&V carrier track (mod 90 deg)
  -> [lock search: rotation x depuncture-alignment hypotheses, batched
      Viterbi decode + re-encode BER, threshold 0.15]
  -> depuncture -> batched overlapped Viterbi -> bit stream
  -> [host] TS deframer -> conv deinterleave -> RS(204,188)
  -> energy-dispersal descramble -> TS packets

The reference's per-sample FLL/Costas loops are replaced by block
feed-forward estimators; its 0/90-degree phase trial and puncture-shift
search (viterbi_all.cpp:74-205) becomes one batched hypothesis decode;
its 180-degree ambiguity is resolved in the deframer (inverted sync).
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import dvbs_fec, rs_spec, scrambling
from ..ops import frontend, plphase, viterbi
from ..io.ts_deframer import TSDeframer as _PyTSDeframer
from ..io import native as _native


def TSDeframer():
    """Native C++ deframer when built (make -C native), python otherwise."""
    if _native.available():
        return _native.NativeTSDeframer()
    return _PyTSDeframer()

BER_THRESHOLD = 0.15
TEST_BITS = 2048


@dataclasses.dataclass
class DVBSBlockResult:
    ts_packets: np.ndarray        # [n, 188] uint8
    viterbi_ber: float
    viterbi_lock: bool
    detected_rate: str | None
    rs_avg_errors: float
    deframer_errors: int
    n_symbols: int
    constellation: np.ndarray | None = None   # [1024] complex64 scatter
                                  # (symToSoft side-channel, main.cpp:515-521)
    frames: int = 0               # 1632-byte super-frames deframed this block
    groups_ok: int = 0            # dispersal groups with all 8 RS decodes ok


class DVBSReceiver:
    """Streaming DVB-S demodulator with automatic rate/phase lock."""

    def __init__(self, rate: str | None = None,
                 block_symbols: int = 1 << 16,
                 native_tail: bool | None = None):
        self.block_symbols = block_symbols
        self.fixed_rate = rate
        self.locked = False
        self.rate: str | None = rate
        self.rotation = 0
        self.drop = 0
        self.ber = 1.0
        self.out_of_sync = 0
        # host tail: the C++ fused deframe+deinterleave+RS+descramble
        # (native/dvbs_native.cpp dvbstail_*) when built, else the pure
        # python chain — byte-identical, checkpoint-interchangeable
        if native_tail is None:
            from ..io import native as io_native
            native_tail = io_native.available()
        self.native_tail = bool(native_tail)
        self._reset_tail()
        self._fifo = np.zeros(0, np.complex64)
        self._llr_carry = np.zeros(0, np.float32)
        self._front = self._build_front()
        self._locked_cache = {}      # (rate, rot, carry_len) -> jitted chain
        self._hints = np.array([0, 0, 0, 0, 1], np.float32)  # first=1
        self.last_consumed = 2 * block_symbols
        self.rs_avg_errors = 0.0

    # ------------------------------------------------------------------
    def _reset_tail(self):
        if self.native_tail:
            from ..io.native import NativeDVBSTail
            self._ntail = NativeDVBSTail()
        else:
            self._ntail = None
            self.deframer = TSDeframer()
            self.deinterleaver = dvbs_fec.ConvDeinterleaver()
            self._deint_fifo = np.zeros(0, np.uint8)
            self._group_sync = False

    @property
    def sync_errors(self) -> int:
        return (self._ntail.sync_errors if self._ntail is not None
                else self.deframer.sync_errors)

    # ------------------------------------------------------------------
    def _build_front(self):
        @jax.jit
        def front(samples_ri, hints):
            # hints: [cfo, nco_phase, tau, theta, first]
            # samples arrive as float16 re/im (half the upload of
            # complex64); AGC renormalizes so the reduced range costs
            # nothing
            first = hints[4] > 0.5
            s = (samples_ri[0].astype(jnp.float32) +
                 1j * samples_ri[1].astype(jnp.float32)
                 ).astype(jnp.complex64)
            x = frontend.agc(s)
            cfo = jnp.where(first, frontend.coarse_cfo_estimate(x), hints[0])
            nco_phase = jnp.where(first, 0.0, hints[1])
            x = frontend.mix(x, cfo, nco_phase)
            n2 = x.shape[-1]
            y = frontend.matched_filter(x)
            z, tau_u, tau_end = frontend.recover_symbols_full(
                y, n_windows=16,
                tau_hint=jnp.where(first, jnp.nan, hints[2]))
            # continuity: unwrap tau to the carried value unless first block
            # (recover_symbols_full treats nan hint as "no hint" via where)
            S = z.shape[-1]
            # precise residual carrier from the 4th-power spectral line —
            # the lag-1 coarse estimate alone is too noisy for V&V tracking
            f4 = frontend.qpsk_residual_freq(z)
            ks = jnp.arange(S)
            z = z * jnp.exp(-1j * f4 * ks).astype(z.dtype)
            theta0 = jnp.where(first, 0.0, hints[3])
            ph = plphase.qpsk_vv_track(z[None, :], theta0[None])[0]
            zc = z * jnp.exp(-1j * ph).astype(z.dtype)
            soft = jnp.stack([jnp.real(zc), jnp.imag(zc)], axis=1)
            new_hints = jnp.stack([
                cfo,
                jnp.mod(nco_phase + cfo * n2, 2 * jnp.pi),
                tau_end,
                f4 * S + ph[-1],
                jnp.zeros(()),
            ])
            # constellation side-channel (symToSoft scatter, main.cpp:515-521;
            # stacked re/im)
            scat = jnp.stack([jnp.real(zc[:1024]), jnp.imag(zc[:1024])])
            # float16 softs halve the fetch; the Viterbi
            # branch metrics and RS chain are insensitive to the range
            return soft.reshape(-1).astype(jnp.float16), new_hints, scat
        return front

    # ------------------------------------------------------------------
    @staticmethod
    def _rotate_serial(soft: np.ndarray, rot: int) -> np.ndarray:
        """Apply a 90-degree rotation hypothesis to serialized (I,Q) softs:
        z' = z * exp(-j*pi/2): I' = Q, Q' = -I."""
        if rot == 0:
            return soft
        pairs = soft.reshape(-1, 2)
        out = np.empty_like(pairs)
        out[:, 0] = pairs[:, 1]
        out[:, 1] = -pairs[:, 0]
        return out.reshape(-1)

    def _try_lock(self, soft: np.ndarray):
        """Batched hypothesis search (reference viterbi_all.cpp:76-205)."""
        rates = [self.fixed_rate] if self.fixed_rate else dvbs_fec.RATES
        best = None
        for rate in rates:
            px, _ = dvbs_fec.PUNCTURE[rate]
            p = len(px)
            n_kept = int(px.sum() + dvbs_fec.PUNCTURE[rate][1].sum())
            drops = list(range(0, 2 * n_kept, 2))
            hyps = []
            keys = []
            need = TEST_BITS + 2 * n_kept
            for rot in (0, 1):
                s = self._rotate_serial(soft[:need + 64], rot)
                for d in drops:
                    dl = dvbs_fec.depuncture(s[d:d + TEST_BITS], rate, 0)
                    hyps.append(dl[: (TEST_BITS * 2 * p) // n_kept // 2 * 1])
                    keys.append((rot, d))
            L = min(len(h) for h in hyps)
            batch = np.stack([h[:L] for h in hyps]).astype(np.float32)
            bits = np.asarray(viterbi.decode_segments(jnp.asarray(batch)))
            for (rot, d), hyp_bits, hyp_llr in zip(keys, bits, batch):
                re_xy = dvbs_fec.cc_encode(hyp_bits)
                mask = hyp_llr != 0
                hard_rx = (hyp_llr < 0).astype(np.uint8)
                n = mask.sum()
                ber = float((re_xy[mask] != hard_rx[mask]).sum()) / max(n, 1)
                if best is None or ber < best[0]:
                    best = (ber, rate, rot, d)
        if best and best[0] < BER_THRESHOLD:
            self.ber, self.rate, self.rotation, self.drop = best
            self.locked = True
            self.out_of_sync = 0
            self._llr_carry = np.zeros(0, np.float32)
            self._reset_tail()
        else:
            self.locked = False

    # ------------------------------------------------------------------
    def _update_hints(self, new_hints: np.ndarray, n: int):
        """Carry DSP state across blocks: fold whole-sample timing drift
        into the host FIFO advance so the carried tau stays inside the
        resampler span; NCO phase continuity accounts for the advance."""
        old_nco = float(self._hints[1])
        self._hints = new_hints.copy()
        tau_end = float(self._hints[2])
        adv = n - int(round(2.0 * tau_end))
        self.last_consumed = adv
        self._hints[2] = tau_end - round(2.0 * tau_end) / 2.0
        cfo = float(self._hints[0])
        self._hints[1] = (old_nco + cfo * adv) % (2 * np.pi)

    # ------------------------------------------------------------------
    def _get_locked_chain(self, n_samples: int):
        """Fused device program for the locked steady state: front end ->
        rotation -> depuncture -> segmented Viterbi -> re-encode BER ->
        packed bits, all in one chain — the host fetches 1 bit per 2
        softs (x32 less transfer than fetching the soft stream).
        Keyed on (rate, rotation, carry length): the carry length is
        constant once the stream reaches steady state, so each lock
        compiles at most a handful of variants.
        """
        c = len(self._llr_carry)
        key = (self.rate, self.rotation, c, n_samples)
        hit = self._locked_cache.get(key)
        if hit is not None:
            return hit
        px, py = dvbs_fec.PUNCTURE[self.rate]
        p = len(px)
        pat = np.stack([px, py], axis=1).reshape(-1).astype(bool)
        n_kept = int(pat.sum())
        pat_idx = np.nonzero(pat)[0]
        m = c + n_samples                  # serial soft-stream length
        n_use = m // n_kept * n_kept
        periods = n_use // n_kept
        n_pairs = periods * p
        core, wing = 2048, 96
        B = -(-n_pairs // core)
        TB = min(TEST_BITS, n_pairs)
        rot = self.rotation
        front = self._front

        @jax.jit
        def chain(ri, hints, carry):
            soft16, new_hints, scat = front(ri, hints)
            s = soft16.astype(jnp.float32)
            if rot:
                pr = s.reshape(-1, 2)
                s = jnp.stack([pr[:, 1], -pr[:, 0]], axis=1).reshape(-1)
            stream = jnp.concatenate([carry, s]) if c else s
            used = stream[:n_use].reshape(periods, n_kept)
            dl2 = jnp.zeros((periods, 2 * p), jnp.float32)
            dl2 = dl2.at[:, pat_idx].set(used)     # static-column scatter
            dl = dl2.reshape(-1, 2)
            padded = jnp.zeros((B * core + 2 * wing, 2), jnp.float32)
            padded = padded.at[wing:wing + n_pairs].set(dl)
            segs = jnp.stack([jax.lax.slice(
                padded, (i * core, 0), (i * core + core + 2 * wing, 2))
                for i in range(B)])
            bits_seg = viterbi.decode_segments(segs)
            bits = bits_seg[:, wing:wing + core].reshape(-1)[:n_pairs]
            # re-encode BER over the first TB pairs (start state 0, the
            # same approximation as the host watchdog)
            bp = jnp.concatenate([jnp.zeros(6, bits.dtype), bits[:TB]])

            def enc(poly):
                # v = (b[i] << 6) | last-6-bits: poly bit j taps b[i-(6-j)]
                acc = jnp.zeros(TB, jnp.int32)
                for j in range(7):
                    if (poly >> j) & 1:
                        acc = acc + bp[j:j + TB].astype(jnp.int32)
                return acc % 2
            exy = jnp.stack([enc(dvbs_fec.G1), enc(dvbs_fec.G2)], axis=1)
            chunk = dl[:TB]
            maskz = chunk != 0
            hard = (chunk < 0).astype(jnp.int32)
            nm = jnp.sum(maskz)
            ber = jnp.sum(jnp.where(maskz, (exy != hard).astype(jnp.int32),
                                    0)) / jnp.maximum(nm, 1)
            nb8 = -(-n_pairs // 8) * 8
            bits_p = jnp.concatenate(
                [bits, jnp.zeros(nb8 - n_pairs, bits.dtype)])
            packed = frontend.pack_bits_to_bytes(bits_p)
            return dict(bits=packed, ber=jnp.reshape(ber, (1,)),
                        hints=new_hints, scat=scat,
                        carry=stream[n_use:])

        entry = (chain, n_pairs)
        self._locked_cache[key] = entry
        return entry

    # ------------------------------------------------------------------
    # Locked-path pipelining: dispatch (async device chain) / fetch
    # (device outputs -> DSP state update) / host tail (deframe, RS) are
    # split so DVBSStream can run the host tail of block i while the
    # device computes block i+1 — the S2 driver's dispatch/finalize
    # overlap (models/driver.py), which the reference gets from its
    # per-Processor threads (module_dvbs_demod.h:32-44).
    def dispatch_locked(self, samples: np.ndarray):
        """Async-dispatch one locked block. Requires self.locked and
        drop == 0. Returns an opaque ctx for fetch_locked."""
        s = np.asarray(samples)
        n = len(s)
        scale = np.sqrt(np.mean(np.abs(s) ** 2)) + 1e-30
        sn = s / scale
        ri = np.stack([sn.real.astype(np.float16),
                       sn.imag.astype(np.float16)])
        chain, n_pairs = self._get_locked_chain(n)
        out = chain(jnp.asarray(ri), jnp.asarray(self._hints),
                    jnp.asarray(self._llr_carry))
        return dict(out=out, n=n, n_pairs=n_pairs)

    def fetch_locked(self, ctx):
        """Fetch a dispatched block's outputs and update the DSP state
        (hints/carry/BER watchdog). Returns (bits, constellation, n)."""
        out = jax.device_get(ctx["out"])   # one batched fetch
        scat = np.asarray(out["scat"])
        constellation = (scat[0] + 1j * scat[1]).astype(np.complex64)
        self._update_hints(np.asarray(out["hints"]), ctx["n"])
        self._llr_carry = np.asarray(out["carry"]).astype(np.float32)
        bits = np.unpackbits(np.asarray(out["bits"]))[:ctx["n_pairs"]]
        self.ber = float(np.asarray(out["ber"])[0])
        if self.ber > BER_THRESHOLD:
            self.out_of_sync += 1
            if self.out_of_sync > 20:      # reference's 20-strike rule
                self.locked = False
        else:
            self.out_of_sync = 0
        return bits, constellation, ctx["n"]

    def process_block(self, samples: np.ndarray) -> DVBSBlockResult:
        if self.locked and self.drop == 0:
            bits, constellation, n = self.fetch_locked(
                self.dispatch_locked(samples))
            return self._host_tail(bits, constellation, n // 2)

        s = np.asarray(samples)
        n = len(s)
        scale = np.sqrt(np.mean(np.abs(s) ** 2)) + 1e-30
        sn = s / scale   # pre-normalize so float16 transport cannot clip
        ri = np.stack([sn.real.astype(np.float16), sn.imag.astype(np.float16)])

        soft_j, hints_j, scat_j = self._front(jnp.asarray(ri),
                                              jnp.asarray(self._hints))
        soft = np.asarray(soft_j).astype(np.float32)
        scat = np.asarray(scat_j)
        constellation = (scat[0] + 1j * scat[1]).astype(np.complex64)
        self._update_hints(np.asarray(hints_j), n)
        soft_len = len(soft)

        if not self.locked:
            self._try_lock(soft)
            if not self.locked:
                return DVBSBlockResult(np.zeros((0, 188), np.uint8),
                                       self.ber, False, None, 0.0,
                                       self.sync_errors,
                                       soft_len // 2,
                                       constellation=constellation)

        srot = self._rotate_serial(soft, self.rotation)
        stream = np.concatenate([self._llr_carry, srot[self.drop:]]) \
            if self.drop or len(self._llr_carry) else srot
        self.drop = 0  # only applied once; carry keeps continuity
        px, py = dvbs_fec.PUNCTURE[self.rate]
        n_kept = int(px.sum() + py.sum())
        n_use = (len(stream) // n_kept) * n_kept
        self._llr_carry = stream[n_use:].astype(np.float32)
        dl = dvbs_fec.depuncture(stream[:n_use], self.rate, 0)
        bits = viterbi.decode_stream(dl.astype(np.float32))

        # watchdog: re-encode BER on a sample of the block
        re_xy = dvbs_fec.cc_encode(bits[:TEST_BITS])
        chunk = dl[:TEST_BITS]
        mask = chunk != 0
        self.ber = float((re_xy[:TEST_BITS][mask] !=
                          (chunk < 0).astype(np.uint8)[mask]).mean()) \
            if mask.any() else 1.0

        if self.ber > BER_THRESHOLD:
            self.out_of_sync += 1
            if self.out_of_sync > 20:      # reference's 20-strike rule
                self.locked = False
        else:
            self.out_of_sync = 0
        return self._host_tail(bits, constellation, soft_len // 2)

    def _host_tail(self, bits: np.ndarray, constellation, n_symbols: int
                   ) -> DVBSBlockResult:
        """Pure host: deframe -> deinterleave -> RS -> descramble.
        One fused C++ call when native is built (byte-identical python
        fallback below, cross-checked by tests/test_dvbs_e2e.py)."""
        if self._ntail is not None:
            nt = self._ntail
            ts = nt.feed(bits)
            self.rs_avg_errors = nt.rs_avg_errors
            return DVBSBlockResult(ts, self.ber, self.locked, self.rate,
                                   self.rs_avg_errors, nt.sync_errors,
                                   n_symbols, constellation=constellation,
                                   frames=nt.frames, groups_ok=nt.groups_ok)
        frames = self.deframer.feed(bits)
        pkts = []
        rs_errs = []
        groups_ok = 0
        for frame in frames:
            # the Forney deinterleaver delays every byte by 11*17 cycles
            # (2244 bytes = 3 packets), so dispersal-group alignment is
            # re-established on its output stream
            self._deint_fifo = np.concatenate(
                [self._deint_fifo, self.deinterleaver.process(frame)])
        while len(self._deint_fifo) >= 204:
            if not self._group_sync:
                syncs = self._deint_fifo[:len(self._deint_fifo) // 204 * 204:204]
                hits = np.nonzero(syncs == 0xB8)[0]
                if len(hits) == 0:
                    keep = (len(self._deint_fifo) // 204 - 1) * 204
                    self._deint_fifo = self._deint_fifo[max(keep, 0):]
                    break
                self._deint_fifo = self._deint_fifo[hits[0] * 204:]
                self._group_sync = True
            if len(self._deint_fifo) < 8 * 204:
                break
            grp_in = self._deint_fifo[:8 * 204]
            if grp_in[0] != 0xB8:
                self._group_sync = False
                continue
            self._deint_fifo = self._deint_fifo[8 * 204:]
            group = np.empty(8 * 188, np.uint8)
            grp_clean = True
            for k in range(8):
                fixed, nerr = rs_spec.decode(grp_in[k * 204:(k + 1) * 204])
                rs_errs.append(max(nerr, 0) if nerr >= 0 else 8)
                grp_clean = grp_clean and nerr >= 0
                group[k * 188:(k + 1) * 188] = fixed[:188]
            groups_ok += int(grp_clean)
            group = scrambling.dvbs_descramble_group(group)
            pkts.append(group.reshape(8, 188))
        self.rs_avg_errors = float(np.mean(rs_errs)) if rs_errs else 0.0
        ts = np.concatenate(pkts) if pkts else np.zeros((0, 188), np.uint8)
        return DVBSBlockResult(ts, self.ber, self.locked, self.rate,
                               self.rs_avg_errors, self.deframer.sync_errors,
                               n_symbols, constellation=constellation,
                               frames=int(len(frames)), groups_ok=groups_ok)


    # -- loop-state checkpointing (SURVEY.md sec. 5): every mutable DSP
    # scalar/array the reference would lose on restart — lock state,
    # carried hints, depuncture carry, deinterleaver FIFOs, deframer and
    # group-sync state — so restore-and-continue equals uninterrupted.
    # The tail fields use ONE format for both tail implementations, so a
    # checkpoint written with the native tail restores into the python
    # tail and vice versa.
    def get_state(self) -> dict:
        if self._ntail is not None:
            tail = self._ntail.get_state()
        else:
            tail = dict(
                deframer_state=self.deframer.get_state(),
                deint_fifos=[f.copy() for f in self.deinterleaver.fifos],
                deint_fifo=self._deint_fifo.copy(),
                group_sync=self._group_sync)
        return dict(locked=self.locked, rate=self.rate,
                    rotation=self.rotation, drop=self.drop, ber=self.ber,
                    out_of_sync=self.out_of_sync,
                    hints=self._hints.copy(),
                    llr_carry=self._llr_carry.copy(),
                    rs_avg_errors=self.rs_avg_errors,
                    last_consumed=self.last_consumed, **tail)

    def set_state(self, st: dict):
        self.locked = bool(st["locked"])
        self.rate = st["rate"]
        self.rotation = int(st["rotation"])
        self.drop = int(st["drop"])
        self.ber = float(st["ber"])
        self.out_of_sync = int(st["out_of_sync"])
        self._hints = np.asarray(st["hints"], np.float32).copy()
        self._llr_carry = np.asarray(st["llr_carry"], np.float32).copy()
        self._reset_tail()
        if self._ntail is not None:
            self._ntail.set_state(st)
        else:
            self.deframer.set_state(st["deframer_state"])
            self.deinterleaver.fifos = [np.asarray(f, np.uint8).copy()
                                        for f in st["deint_fifos"]]
            self._deint_fifo = np.asarray(st["deint_fifo"], np.uint8).copy()
            self._group_sync = bool(st["group_sync"])
        self.rs_avg_errors = float(st["rs_avg_errors"])
        self.last_consumed = int(st["last_consumed"])


class DVBSStream:
    """FIFO wrapper matching DVBS2Stream's interface for the CLI."""

    def __init__(self, rate: str | None = None, block_symbols: int = 1 << 16,
                 native_tail: bool | None = None):
        self.rx = DVBSReceiver(rate=rate, block_symbols=block_symbols,
                               native_tail=native_tail)
        self._fifo = np.zeros(0, np.complex64)
        self.block_symbols = block_symbols
        self.metrics = type("M", (), {})()
        self._reset_metrics()

    def _reset_metrics(self):
        # the DVB-S metric set under its own names (SURVEY.md sec. 3.5 /
        # module_dvbs_demod.cpp:101-115, GUI main.cpp:340-351)
        m = self.metrics
        m.viterbi_ber = 1.0
        m.viterbi_sig_level = 0.0      # 100 - avg30(BER) * (100/0.3)
        m.viterbi_lock = False
        m.viterbi_rate = None          # "1/2".."7/8" once locked
        m.rs_avg_errors = 0.0
        m.deframer_errors = 0
        m.frames_ok = 0
        m.frames_seen = 0
        # 30-entry rolling windows, mirroring the reference GUI's ring
        # buffers (main.cpp:340-351): sig level and RS averages smooth
        # over the last 30 processed blocks
        self._ber_ring = collections.deque(maxlen=30)
        self._rs_ring = collections.deque(maxlen=30)

    def feed(self, samples: np.ndarray) -> bytes:
        """Pipelined: once locked, block i+1 is dispatched to the device
        before block i's host tail (deframe/deinterleave/RS) runs, so
        host FEC overlaps device compute — the same overlap the S2
        driver gets from its dispatch/finalize split."""
        self._fifo = np.concatenate([self._fifo,
                                     np.asarray(samples, np.complex64)])
        out = bytearray()
        n = 2 * self.block_symbols
        pending = None
        while True:
            if pending is not None:
                bits, const, nn = self.rx.fetch_locked(pending)
                self._fifo = self._fifo[self.rx.last_consumed:]
                pending = None
                if self.rx.locked and self.rx.drop == 0 and \
                        len(self._fifo) >= n:
                    pending = self.rx.dispatch_locked(self._fifo[:n])
                res = self.rx._host_tail(bits, const, nn // 2)
            elif len(self._fifo) >= n:
                if self.rx.locked and self.rx.drop == 0:
                    pending = self.rx.dispatch_locked(self._fifo[:n])
                    continue
                res = self.rx.process_block(self._fifo[:n])
                self._fifo = self._fifo[self.rx.last_consumed:]
            else:
                break
            out.extend(res.ts_packets.reshape(-1).tobytes())
            m = self.metrics
            m.viterbi_ber = float(res.viterbi_ber)
            self._ber_ring.append(float(res.viterbi_ber))
            m.viterbi_sig_level = max(
                0.0, 100.0 - float(np.mean(self._ber_ring)) * (100.0 / 0.3))
            m.viterbi_lock = bool(res.viterbi_lock)
            m.viterbi_rate = res.detected_rate
            if res.frames:                 # blocks with RS activity only
                self._rs_ring.append(float(res.rs_avg_errors))
            m.rs_avg_errors = float(np.mean(self._rs_ring)) \
                if self._rs_ring else 0.0
            m.deframer_errors = int(res.deframer_errors)
            # real super-frame counts, not block counts: frames_seen is
            # 1632-byte frames deframed, frames_ok is dispersal groups
            # whose 8 RS codewords all decoded (same 1632-byte unit,
            # shifted by the deinterleaver delay)
            m.frames_seen += int(res.frames)
            m.frames_ok += int(res.groups_ok)
        return bytes(out)

    def get_state(self) -> dict:
        """Snapshot for seamless restart (parity with DVBS2Stream).
        feed() drains its pipelined dispatch before returning, so there
        is never an in-flight block at snapshot time."""
        m = self.metrics
        return dict(rx=self.rx.get_state(),
                    fifo=self._fifo.copy(),
                    ber_ring=list(self._ber_ring),
                    rs_ring=list(self._rs_ring),
                    metrics={k: getattr(m, k) for k in (
                        "viterbi_ber", "viterbi_sig_level", "viterbi_lock",
                        "viterbi_rate", "rs_avg_errors", "deframer_errors",
                        "frames_ok", "frames_seen")})

    def set_state(self, st: dict):
        self.rx.set_state(st["rx"])
        self._fifo = np.asarray(st["fifo"], np.complex64).copy()
        self._ber_ring = collections.deque(st["ber_ring"], maxlen=30)
        self._rs_ring = collections.deque(st["rs_ring"], maxlen=30)
        for k, v in st["metrics"].items():
            setattr(self.metrics, k, v)
