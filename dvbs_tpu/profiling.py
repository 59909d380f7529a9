"""Tracing and per-stage observability (SURVEY.md sec. 5).

Two complementary surfaces:

- `device_trace(logdir)`: context manager around jax.profiler.trace —
  captures an XLA device trace viewable in TensorBoard/Perfetto, the
  replacement for the reference's (absent) profiler hooks.
- `PipelineStats`: lightweight host-side counters the streaming drivers
  update per block — samples in, frames seen/ok, TS bytes out, LDPC
  trial histogram, and wall-time per pipeline stage (dispatch / fetch /
  host-parse). Near-zero overhead (a few time.perf_counter calls per
  ~100 ms block); always on.

Usage:
    stream = DVBS2Stream(...)
    ... feed ...
    print(stream.stats.report())

    with profiling.device_trace("/tmp/jax-trace"):
        stream.feed(samples)
"""
from __future__ import annotations

import collections
import contextlib
import time


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace of everything inside the block."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageClock:
    """Accumulates wall time per named stage."""

    def __init__(self):
        self.total = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.calls[name] += 1


class PipelineStats:
    """Per-stream counters mirroring (and extending) the reference GUI's
    live numbers (main.cpp:440-500)."""

    def __init__(self):
        self.clock = StageClock()
        self.samples_in = 0
        self.blocks = 0
        self.frames_seen = 0
        self.frames_ok = 0
        self.ts_bytes_out = 0
        self.trial_hist = collections.Counter()   # ldpc sweeps -> frames
        self._t_start = time.perf_counter()

    def block_done(self, n_samples: int, frame_ok, trials, ts_bytes: int):
        self.blocks += 1
        self.samples_in += int(n_samples)
        self.frames_seen += len(frame_ok)
        self.frames_ok += int(sum(bool(f) for f in frame_ok))
        self.ts_bytes_out += int(ts_bytes)
        for t in trials:
            self.trial_hist[int(t)] += 1

    def report(self) -> str:
        el = time.perf_counter() - self._t_start
        lines = [
            f"blocks {self.blocks}  samples {self.samples_in}"
            f" ({self.samples_in / max(el, 1e-9) / 1e6:.2f} Msamp/s wall)",
            f"frames {self.frames_ok}/{self.frames_seen} ok"
            f"  ts_bytes {self.ts_bytes_out}",
            "ldpc trials: " + " ".join(
                f"{k}:{v}" for k, v in sorted(self.trial_hist.items())),
        ]
        for name in self.clock.total:
            t, c = self.clock.total[name], self.clock.calls[name]
            lines.append(f"  stage {name:12s} {t * 1e3:9.1f} ms total"
                         f"  {t / max(c, 1) * 1e3:7.2f} ms/call x{c}")
        return "\n".join(lines)
