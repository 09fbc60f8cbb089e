"""Timing, tracing and progress.

Counterpart of ``npe_pfn_tpu/utils/profiling.py``:

- ``PhaseTimers``: wall-clock phase timers that synchronize the CUDA devices
  of a given result before reading the clock (JAX blocks on it);
- ``trace``: a ``torch.profiler`` context that writes a Chrome trace;
- ``Progress``: a counter for the host-driven rejection loops.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def _synchronize(obj) -> None:
    """Wait for every CUDA device that holds a tensor of ``obj`` (a tensor,
    or a list, tuple or dict of them)."""
    if torch.is_tensor(obj):
        if obj.device.type == "cuda":
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _synchronize(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _synchronize(v)


class PhaseTimers:
    """Accumulating per-phase timers, synchronized on the device."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: object = None) -> Iterator[None]:
        """Time the block; with ``sync`` (its result), wait for the device
        work behind it first."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_s": round(self.totals[k] / max(self.counts[k], 1), 4),
            }
            for k in sorted(self.totals)
        }

    def __str__(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "npe_pfn_tpu_torch_trace")
          ) -> Iterator[str]:
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where there is a
    card), written as ``<log_dir>/trace.json`` for chrome://tracing or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Progress:
    """Minimal progress reporter (a tqdm analog): prints the count and rate
    on each update, and only when enabled."""

    def __init__(self, total: int, desc: str = "", enabled: bool = True):
        self.total = total
        self.desc = desc
        self.enabled = enabled
        self.n = 0
        self._t0 = time.perf_counter()

    def update(self, n: int) -> None:
        self.n += n
        if self.enabled:
            rate = self.n / max(time.perf_counter() - self._t0, 1e-9)
            print(f"\r{self.desc}: {self.n}/{self.total} ({rate:.0f}/s)",
                  end="" if self.n < self.total else "\n", flush=True)
