"""DVB-S2 receiver: block-batched device pipeline.

The accelerator counterpart of the reference's DVBS2Demod processing chain
(/root/reference/src/demod/dvbs2/module_dvbs2_demod.cpp:216-371):

  samples (2 sps) -> AGC -> coarse CFO mix -> matched RRC filter
  -> feed-forward timing recovery -> PL-frame sync (batched correlation)
  -> per-frame coarse FED + anchored phase recovery -> PL descramble
  -> soft demap -> bit deinterleave -> batched LDPC decode
  -> [host] BCH correct -> BB descramble -> BBFRAMEs

The front end runs in one jitted program per block and LDPC + BCH
syndromes + byte packing in a second one; the BCH fix-up (rare path)
runs on host.  All frames in a
block decode together on the LDPC lane axis — the reference decodes only
1 in 16 (bbframe_ldpc.cpp:129-133).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import modcod, interleaver, scrambling, bch_spec
from ..ops import frontend, plsync, plphase, plhdr, demap, routes, bch


@dataclasses.dataclass
class BlockResult:
    """Host-side result of one processed block."""
    bbframes: np.ndarray          # [F_ok, kbch/8] uint8 (descrambled)
    frame_ok: np.ndarray          # [F] bool (LDPC converged & BCH fixable)
    sync_quality: np.ndarray      # [F] float32 (PL correlation peak)
    freq_err: np.ndarray          # [F] float32 rad/symbol residual
    ldpc_trials: np.ndarray       # [F] int32
    bch_corrections: np.ndarray   # [F] int32 (-1 = failure)
    detected_pls: np.ndarray      # [F] int32
    coarse_cfo: float             # rad/sample applied to the block
    n_symbols: int                # symbols consumed (frames * L)
    last_frame_end: int = 0       # symbol index just past the last frame
    constellation: np.ndarray | None = None  # [2048] complex64 scatter
                                  # (first 90 points = PLHEADER)
    detected_pls_conf: np.ndarray | None = None  # [F] float32 confidence
    starts: np.ndarray | None = None  # [F] int32 located frame starts
                                  # (symbol index; parser gap detection)


class DVBS2Receiver:
    """Fixed-MODCOD DVB-S2 demodulator (auto-MODCOD layered on top).

    Parameters mirror DVBS2Demod::init (module_dvbs2_demod.cpp:7-91).
    """

    def __init__(self, mc: int = 4, short: bool = True, pilots: bool = False,
                 block_symbols: int = 1 << 15, max_ldpc_trials: int = 32,
                 sof_threshold: float = 0.6, g1: float | None = None,
                 g2: float | None = None, equalize: bool = False,
                 interpret: bool = False, dummy_aware: bool = False):
        """The LDPC decoder is the route of the platform the program is
        lowered for (ops/routes.py); interpret=True runs the GPU kernel
        in Pallas interpret mode instead (CPU tests)."""
        self.cfg = modcod.get_config(mc, short=short, pilots=pilots)
        self.block_symbols = block_symbols
        self.max_ldpc_trials = max_ldpc_trials
        self.sof_threshold = sof_threshold
        self.equalize = equalize
        self.interpret = interpret
        # dummy_aware: chain-slot the frame grid so interleaved dummy
        # PLFRAMEs (shorter than L) never skip a data SOF — opt-in,
        # the parallel locator stays the default (ops/plsync)
        self.dummy_aware = dummy_aware
        L = self.cfg.plframe_len
        self.edge_margin = 256
        self.n_frames = (block_symbols - 2 * self.edge_margin - 90) // L - 1
        if self.n_frames < 1:
            raise ValueError("block_symbols must cover at least 2 PL frames")
        self._sym_fn = self._build()

    # ------------------------------------------------------------------
    def _build(self):
        cfg = self.cfg
        L = cfg.plframe_len
        F = self.n_frames
        payload_idx = plphase.payload_indices(cfg)
        descr = np.conj(scrambling.pl_scrambler_phasors()[:L - 90])
        m = cfg.mod_bits

        @jax.jit
        def run(samples_ri: jax.Array):
            # samples arrive as stacked [2, n] re/im (float16 or int8,
            # half the upload of complex64; front-end math is f32)
            samples = (samples_ri[0].astype(jnp.float32) +
                       1j * samples_ri[1].astype(jnp.float32)
                       ).astype(jnp.complex64)
            x = frontend.agc(samples)
            cfo = frontend.coarse_cfo_estimate(x)
            x = frontend.mix(x, cfo)
            y = frontend.matched_filter(x)
            z, _ = frontend.recover_symbols(y, n_windows=16)
            if self.equalize:
                # optional LMS equalizer at the reference's insertion point
                # (after timing recovery, before PL sync — the reference
                # instantiates it there but ships it disabled,
                # module_dvbs2_demod.cpp:50,84,242)
                from ..ops import equalizer
                z = equalizer.lms_equalize(z)

            score, _ = plsync.correlate(z)
            if self.dummy_aware:
                starts, quality = plsync.locate_frames_chain(
                    score, L, F, margin=self.edge_margin)
            else:
                starts, quality = plsync.locate_frames(
                    score, L, F, margin=self.edge_margin)
            frames = plsync.extract_frames(z, starts, L)

            # coarse lag-2 FED (wide pull-in) then multi-lag L&R refine
            # (dummy_aware: coherence-weighted — dummy headers carry a
            # different PLS codeword, plphase.coarse_fed_common)
            fed = plphase.coarse_fed_common(frames, cfg,
                                            robust=self.dummy_aware)
            frames = plphase.apply_freq(frames, jnp.broadcast_to(fed, (F,)))
            flr = plphase.lr_freq_common(frames, cfg,
                                         robust=self.dummy_aware)
            frames = plphase.apply_freq(frames, jnp.broadcast_to(flr, (F,)))
            freq = jnp.broadcast_to(fed + flr, (F,))
            theta0 = plphase.header_phase(frames, cfg)

            if cfg.pilots:
                phase = plphase.pilot_anchor_phases(frames, cfg, theta0)
                frames_c = plphase.derotate(frames, phase)
                # payload extraction as static slices (gather-free) —
                # descr stays a fancy-indexed NUMPY constant (host-side)
                payload = plphase.extract_payload(frames_c, cfg) * \
                    descr[None, payload_idx - 90]
            else:
                frames_c = plphase.derotate(frames, theta0[:, None])
                payload = frames_c[:, 90:] * descr[None, :]
                if cfg.constellation == modcod.QPSK:
                    vv = plphase.qpsk_vv_track(payload, jnp.zeros(F))
                else:
                    # pilotless higher-order: decision-directed track
                    vv = plphase.dd_phase_track(payload, jnp.zeros(F),
                                                cfg.constellation,
                                                cfg.g1, cfg.g2)
                payload = plphase.derotate(payload, vv)
                frames_c = frames_c.at[:, 90:].set(
                    plphase.derotate(frames_c[:, 90:], vv))

            pls_idx, pls_conf = plhdr.detect_pls(frames_c[:, :90])

            llrs = demap.soft_demap(payload, cfg.constellation, cfg.g1, cfg.g2)
            # column-twist deinterleave as slices+concat (identity for
            # QPSK), no [:, perm] gather
            llrs = interleaver.deinterleave_device(
                llrs, cfg.constellation, cfg.framesize, cfg.rate)
            # constellation scatter: header (drawn highlighted by UIs, as
            # the reference does, main.cpp:522-529) + payload sample
            scat = jnp.concatenate([frames_c[0, :90], payload[0, :1958]])
            return dict(llrs=llrs,
                        scatter=jnp.stack([jnp.real(scat), jnp.imag(scat)]),
                        quality=quality, freq=freq,
                        cfo=jnp.reshape(cfo, (1,)),
                        pls=pls_idx, pls_conf=pls_conf, starts=starts)

        # BB descrambling is a fixed byte XOR — done on device so the
        # host never touches clean frames (the reference's host loop
        # XORs a precomputed table, bbframe_descramble.cpp:122-143)
        bb_mask = scrambling.bb_scrambler_byte_mask(cfg.kbch // 8)

        def ldpc_decode(llrs, n_iters):
            return routes.ldpc_decode(llrs, cfg.ldpc_table, n_iters,
                                      interpret=self.interpret)

        def make_fec(n_iters):
            @jax.jit
            def fec(llrs):
                hard, n_bad, trials = ldpc_decode(llrs, n_iters)
                ok = n_bad == 0
                bch_bad = bch.syndrome_nonzero(hard[:, :cfg.nbch],
                                               cfg.framesize, cfg.rate)
                kbch_bytes = frontend.pack_bits_to_bytes(
                    hard[:, :cfg.kbch]) ^ bb_mask
                return dict(hard=hard, trials=trials, ldpc_ok=ok,
                            bch_bad=bch_bad, kbch_bytes=kbch_bytes)
            return fec

        # two-pass escalation (the host-level analogue of the reference's
        # bad()-gated trial loop, layered_decoder.hh:121-133): every block
        # pays a short pass; the rare unconverged block retries with the
        # full budget.
        self.pass1_iters = min(10, self.max_ldpc_trials)
        self._fec_fn = make_fec(self.pass1_iters)
        self._fec2_fn = make_fec(self.max_ldpc_trials) \
            if self.max_ldpc_trials > self.pass1_iters else None
        return run

    # ------------------------------------------------------------------
    def dispatch_block(self, samples: np.ndarray):
        """Upload one block and dispatch the device chain (front end ->
        LDPC+BCH syndromes) WITHOUT waiting: returns a dict of device
        arrays. jax dispatch is asynchronous, so the caller can overlap
        host work / further uploads with this block's device compute —
        the device-side analogue of the reference's per-Processor worker
        threads (module_dvbs_demod.h:32-44)."""
        s = np.asarray(samples)
        scale = np.sqrt(np.mean(np.abs(s) ** 2)) + 1e-30
        sn = s / scale   # pre-normalize so float16 transport cannot clip
        ri = np.stack([sn.real.astype(np.float16), sn.imag.astype(np.float16)])
        out = self._sym_fn(jnp.asarray(ri))
        llrs = out.pop("llrs")
        out.update(self._fec_fn(llrs))
        if self._fec2_fn is not None:
            out["_llrs"] = llrs     # device-resident, for escalation only
        return out

    def finalize_block(self, out) -> BlockResult:
        """Fetch a dispatched block's device outputs and run the host
        side (escalation rerun + rare BCH repair).

        The clean path is all-vectorized: frames arrive as descrambled
        kbch bytes packed on device; the [F, nldpc] hard-bit tensor
        stays device-resident and only the rows of BCH-flagged frames
        are ever fetched for host repair."""
        cfg = self.cfg
        llrs = out.pop("_llrs", None)
        hard_dev = out.pop("hard")
        out = jax.device_get(out)   # one batched fetch (small fields)
        F = out["ldpc_ok"].shape[0]
        retried = np.zeros(F, bool)
        hard2_dev = None
        if llrs is not None:
            retry = (~out["ldpc_ok"]) & \
                (np.asarray(out["quality"]) >= self.sof_threshold)
            if retry.any():
                out2 = self._fec2_fn(llrs)
                hard2_dev = out2.pop("hard")
                out2 = jax.device_get(out2)
                for k in ("ldpc_ok", "bch_bad", "kbch_bytes"):
                    out[k] = np.where(
                        retry.reshape((-1,) + (1,) * (out[k].ndim - 1)),
                        out2[k], out[k])
                out["trials"] = np.where(
                    retry, self.pass1_iters + out2["trials"], out["trials"])
                retried = retry
        trials = out["trials"]
        ldpc_ok = out["ldpc_ok"]
        plain = np.array(out["kbch_bytes"])   # descrambled on device

        bch_bad = np.asarray(out["bch_bad"])
        # frame acceptance gate at the PL-sync correlation quality, like the
        # reference (SOF_THRES 0.6, dvbs2_pl_sync.cpp:133-149): sub-threshold
        # frames are noise — reject before spending host BCH work on them
        sync_ok = np.asarray(out["quality"]) >= self.sof_threshold
        bch_corr = np.full(F, -1, np.int32)
        frame_ok = sync_ok & ~bch_bad
        bch_corr[frame_ok] = 0
        for f in np.nonzero(sync_ok & bch_bad)[0]:
            hd = hard2_dev if retried[f] else hard_dev
            bits = np.asarray(jax.device_get(hd[f, :cfg.nbch]))
            fixed, ncorr = bch_spec.decode(bits, cfg.framesize, cfg.rate)
            bch_corr[f] = ncorr
            if ncorr < 0:
                # BCH-inconsistent even after repair: the frame is
                # corrupt with near-certainty (LDPC can converge to a
                # VALID-but-WRONG codeword on garbage input), and one
                # emitted garbage BBHeader desyncs the TS parser's byte
                # continuity for a long stretch — reject, the parser
                # gets a mark_gap instead
                continue
            frame_ok[f] = True
            plain[f] = scrambling.bb_scramble_bytes(
                np.packbits(fixed[:cfg.kbch]))
        return BlockResult(
            bbframes=plain[frame_ok],
            frame_ok=frame_ok,
            sync_quality=np.asarray(out["quality"]),
            freq_err=np.asarray(out["freq"]),
            ldpc_trials=trials,
            bch_corrections=bch_corr,
            detected_pls=np.asarray(out["pls"]),
            coarse_cfo=float(np.asarray(out["cfo"])[0]),
            n_symbols=int(self.n_frames * cfg.plframe_len),
            last_frame_end=int(np.asarray(out["starts"])[-1]) +
            cfg.plframe_len,
            constellation=(out["scatter"][0] +
                           1j * out["scatter"][1]).astype(np.complex64),
            detected_pls_conf=np.asarray(out["pls_conf"]),
            starts=np.asarray(out["starts"]),
        )

    def process_symbols_block(self, samples: np.ndarray) -> BlockResult:
        """Process one block of 2-sps samples (length 2*block_symbols)."""
        return self.finalize_block(self.dispatch_block(samples))
