"""Profiling and cost accounting.

The reference profiled externally ("Very Sleepy" sampling; dissertation p.33
found EDT = 89.98% of runtime) and timed with clock() brackets (main.c:826,
971). Here:

- ``StageTimer``: wall-clock brackets with device sync (honest step timing);
- ``cost_analysis``: XLA's FLOP/byte estimates for a jitted function — the
  "speed-of-light" accounting used to sanity-check kernel efficiency.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall time per named stage (syncs the device on exit)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            jax.effects_barrier()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = [f"{'stage':24s} {'total s':>9s} {'calls':>7s} {'share':>7s}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:9.3f} {self.counts[name]:7d} "
                         f"{100 * t / total:6.1f}%")
        return "\n".join(lines)


def cost_analysis(fn, *args, **kwargs) -> dict:
    """XLA cost analysis of ``jax.jit(fn)`` on the given example args."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, list):
        costs = costs[0] if costs else {}
    return dict(costs or {})
