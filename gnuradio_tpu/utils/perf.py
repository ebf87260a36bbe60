"""Performance counters + probe_rate — the instrumentation plane.

Reference parity: per-block perf counters (gnuradio/block.h:517-655,
accumulated in block_detail.cc:253-315, measured around the work call in
block_executor.cc:497-509): instantaneous/average/variance of work time,
items produced, throughput; `probe_rate` block; exported over ControlPort.

Design: blocks fuse into ONE XLA program, so the natural granularity is
the *step*: wall time per step, items/s at the anchor rate, EMA + variance
(Welford). Per-kernel timings come from the XLA profiler (jax.profiler) —
`trace()` wraps a region for xprof, the gr-perf-monitorx analog."""
from __future__ import annotations

import contextlib
import time


class PerfCounters:
    """Welford-style running stats over step wall times (the pc_* analog)."""

    def __init__(self, items_per_step: int = 0):
        self.items_per_step = items_per_step
        self.reset()

    def reset(self):
        self.n = 0
        self.total_items = 0
        self._mean = 0.0
        self._m2 = 0.0
        self.last = 0.0

    def record(self, dt: float, items: int | None = None):
        self.last = dt
        self.n += 1
        self.total_items += items if items is not None else self.items_per_step
        d = dt - self._mean
        self._mean += d / self.n
        self._m2 += d * (dt - self._mean)

    @contextlib.contextmanager
    def measure(self, items: int | None = None):
        t0 = time.perf_counter()
        yield
        self.record(time.perf_counter() - t0, items)

    # gr::block pc_work_time* analogs
    def work_time(self) -> float:
        return self.last

    def work_time_avg(self) -> float:
        return self._mean

    def work_time_var(self) -> float:
        return self._m2 / self.n if self.n > 1 else 0.0

    def throughput(self) -> float:
        """items/s (pc_throughput_avg analog)."""
        t = self._mean * self.n
        return self.total_items / t if t > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "nsteps": self.n,
            "total_items": self.total_items,
            "work_time": self.work_time(),
            "work_time_avg": self.work_time_avg(),
            "work_time_var": self.work_time_var(),
            "throughput": self.throughput(),
        }


class ProbeRate:
    """gr::blocks::probe_rate analog: EMA of items/s observed at a point."""

    def __init__(self, alpha: float = 0.0001):
        self.alpha = alpha
        self._rate = 0.0
        self._last_t = None
        self._last_items = 0

    def update(self, total_items: int):
        now = time.perf_counter()
        if self._last_t is not None:
            dt = now - self._last_t
            if dt > 0:
                inst = (total_items - self._last_items) / dt
                a = 1.0 - (1.0 - self.alpha) ** max(1, int(
                    total_items - self._last_items))
                self._rate += a * (inst - self._rate)
        self._last_t = now
        self._last_items = total_items

    def rate(self) -> float:
        return self._rate


@contextlib.contextmanager
def trace(name: str = "gnuradio_tpu", log_dir: str | None = None):
    """XLA profiler region (the xprof hook; gr-perf-monitorx analog)."""
    import jax
    if log_dir is None:
        with jax.profiler.TraceAnnotation(name):
            yield
    else:
        with jax.profiler.trace(log_dir):
            yield
