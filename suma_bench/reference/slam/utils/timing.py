"""Hierarchical tic/toc profiler on the host clock (counterpart of
``semantic_suma_tpu/utils/timing.py``): a tic/toc stack plus named labels
with running count, total, max and last. The host loop and the loop closer
record their host-visible phases here; device time per stage is
``core.pipeline.StageTimer``'s (CUDA events).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch


@dataclass
class StageStats:
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    last: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Stopwatch:
    """tic()/toc() stack + named scopes with aggregated statistics."""

    def __init__(self):
        self._stack: List[float] = []
        self.stats: Dict[str, StageStats] = defaultdict(StageStats)

    def tic(self) -> None:
        self._stack.append(time.perf_counter())

    def record(self, label: str, elapsed: float) -> None:
        """Attribute an externally measured duration to ``label``."""
        s = self.stats[label]
        s.count += 1
        s.total += elapsed
        s.max = max(s.max, elapsed)
        s.last = elapsed

    def toc(self, label: Optional[str] = None) -> float:
        elapsed = time.perf_counter() - self._stack.pop()
        if label is not None:
            self.record(label, elapsed)
        return elapsed

    @contextmanager
    def scope(self, label: str, sync: Optional[torch.device] = None):
        """Timed scope; pass a CUDA device as ``sync`` to wait for its queued
        work before stopping the clock (attributing it to this scope)."""
        self.tic()
        try:
            yield
        finally:
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)
            self.toc(label)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"mean_ms": v.mean * 1e3, "max_ms": v.max * 1e3,
                    "last_ms": v.last * 1e3, "count": v.count}
                for k, v in self.stats.items()}

    def report(self) -> str:
        lines = [f"{'stage':<28}{'mean ms':>10}{'max ms':>10}{'count':>8}"]
        for k, v in sorted(self.stats.items()):
            lines.append(f"{k:<28}{v.mean * 1e3:>10.2f}{v.max * 1e3:>10.2f}"
                         f"{v.count:>8}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()
        self._stack.clear()
