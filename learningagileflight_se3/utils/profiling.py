"""Tracing & profiling — a subsystem the reference lacks entirely
(SURVEY.md section 5: its only timing is sleep-based pacing of the PyBullet
viewer, Pybullet_simulation.py:152,203).

Two layers:
  * `StageTimer` — host-side wall-clock accounting of named pipeline stages
    (sample / solve / update / ...), with correct handling of JAX async
    dispatch (block_until_ready on exit if you hand it the stage output).
  * `device_trace` — a context manager around `jax.profiler.trace` producing
    a TensorBoard/XProf-loadable device trace (kernel timelines, device
    memory usage) for any region of the program.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax


class StageTimer:
    """Accumulates wall time per named stage across repeated entries.

    >>> timer = StageTimer()
    >>> with timer("solve", block=sol):   # block: pytree to block_until_ready
    ...     sol = solve(...)
    >>> timer.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def __call__(self, stage: str, block=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if block is not None:
                jax.block_until_ready(block)
            dt = time.perf_counter() - t0
            if stage not in self.totals:
                self.totals[stage] = 0.0
                self.counts[stage] = 0
                self._order.append(stage)
            self.totals[stage] += dt
            self.counts[stage] += 1

    def block(self, value):
        """Block on async results inside a stage; returns the value."""
        jax.block_until_ready(value)
        return value

    def report(self, log_fn=print) -> Dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        for s in self._order:
            n = self.counts[s]
            t = self.totals[s]
            log_fn(
                f"[profile] {s:<20s} {t:8.3f}s  ({100.0 * t / total:5.1f}%)"
                f"  x{n}  {t / n * 1e3:8.2f} ms/call"
            )
        return dict(self.totals)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler device trace into log_dir (TensorBoard 'profile' plugin /
    XProf).  No-op when log_dir is None, so call sites can pass the CLI flag
    straight through."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield
