"""Step timing and profiler integration (port of `tlfea/utils/profiling.py`).

- `StepTimer`: named-phase wall-time accumulator (mean, median and 95th
  percentile ms per phase). A phase given `block_on` waits for the card
  (`torch.cuda.synchronize`) where one of those tensors lies on it, so its
  time includes the device work it queued.
- `trace(logdir)`: a `torch.profiler` window (CPU, and the card's kernels
  where there is one), written to `logdir/trace.json` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

__all__ = ["StepTimer", "trace"]


def _block(block_on) -> None:
    """Wait for every card that holds a tensor of `block_on` (a tensor, or
    lists, tuples and dicts of them)."""
    devices = {t.device for t in tree_leaves(block_on)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall time per named phase; pass the phase's output as `block_on` so
    that the card has finished it when the clock stops."""

    def __init__(self):
        self._samples: dict[str, list[float]] = defaultdict(list)
        self._open: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block(block_on)
            self._samples[name].append(time.perf_counter() - t0)

    def start(self, name: str):
        self._open[name] = time.perf_counter()

    def stop(self, name: str, block_on=None):
        if block_on is not None:
            _block(block_on)
        self._samples[name].append(time.perf_counter() - self._open.pop(name))

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs) * 1e3
            out[name] = {
                "count": len(xs),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.median(a)),
                "p95_ms": float(np.percentile(a, 95)),
                "total_s": float(a.sum() / 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'phase':<24}{'count':>7}{'mean ms':>10}{'p50 ms':>10}{'p95 ms':>10}"]
        for name, s in self.summary().items():
            lines.append(f"{name:<24}{s['count']:>7}{s['mean_ms']:>10.3f}"
                         f"{s['p50_ms']:>10.3f}{s['p95_ms']:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler and write the Chrome trace to
    `logdir/trace.json` (chrome://tracing or Perfetto); yields the
    profiler, whose `key_averages()` tables the operations."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
