"""Progress reporting for the host-driven rejection loop.

Counterpart of ``npe_pfn_tpu/utils/profiling.py``'s ``Progress``; the rest of
that module (phase timers, traces) is not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import time


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
