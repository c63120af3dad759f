"""Performance instrumentation.

Reference analogue: interface/perform.{h,cpp} — an RDTSC micro-profiler
bracketing hot loops with min/max/avg per-sample stats.  Equivalent here:
wall-clock stage timing around jitted calls (device-synchronized) plus a
jax.profiler trace hook for per-kernel analysis in TensorBoard/xprof.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class StageTimer:
    """Accumulates per-stage wall times; ns/sample like the reference's
    ReadPerformance report."""
    stats: dict[str, list[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str, result_holder: list | None = None):
        t0 = time.perf_counter()
        yield
        if result_holder:
            jax.block_until_ready(result_holder[-1])
        self.stats.setdefault(name, []).append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args):
        """Run fn(*args), block on the result, record the time, return it."""
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        self.stats.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def lap(self, name: str) -> None:
        """Sample-to-sample mode: record the interval since the previous
        lap() with this name (the reference's second bracket mode,
        interface/perform.cpp Start2StopPerformance)."""
        now = time.perf_counter()
        last = getattr(self, "_laps", {}).get(name)
        if not hasattr(self, "_laps"):
            self._laps = {}
        if last is not None:
            self.stats.setdefault(name, []).append(now - last)
        self._laps[name] = now

    def report(self, samples_per_call: dict[str, int] | None = None) -> str:
        lines = []
        for name, ts in self.stats.items():
            ts_steady = ts[1:] if len(ts) > 1 else ts   # drop compile call
            avg = sum(ts_steady) / len(ts_steady)
            line = (f"{name:20s} n={len(ts):4d} min={min(ts_steady)*1e3:8.3f}ms "
                    f"avg={avg*1e3:8.3f}ms max={max(ts_steady)*1e3:8.3f}ms")
            if samples_per_call and name in samples_per_call:
                line += f"  {avg / samples_per_call[name] * 1e9:8.2f} ns/samp"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/cutesdr_trace"):
    """jax.profiler trace context (view with xprof/TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
