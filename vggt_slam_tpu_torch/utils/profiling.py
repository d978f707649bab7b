"""Per-stage wall-time accounting (counterpart of vggt_slam_tpu/utils/
profiling.py): `StageTimer` accumulates host-clock seconds per named stage.
Device work queued inside a stage is counted where the host waits for it
(`sync`, or the solver's copy events)."""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch


def sync() -> None:
    """Wait for all queued device work (no-op without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """with timer.stage("vggt_forward"): ...  accumulates per-stage time."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.samples: dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def summary(self) -> dict:
        def tail_mean(xs):
            rest = xs[2:] or xs[-1:]
            return sum(rest) / len(rest) * 1e3

        return {name: {"total_s": t, "count": self.counts[name],
                       "mean_ms": t / max(self.counts[name], 1) * 1e3,
                       "min_ms": min(self.samples[name]) * 1e3,
                       "tail_mean_ms": tail_mean(self.samples[name])}
                for name, t in sorted(self.totals.items(),
                                      key=lambda kv: -kv[1])}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)
