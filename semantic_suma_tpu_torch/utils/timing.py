"""Hierarchical tic/toc profiler on the host clock (counterpart of
``semantic_suma_tpu/utils/timing.py``): a tic/toc stack plus named labels
with running count, total, max and last. The host loop, the odometry step,
the loop closer and the segmenter record their host-visible phases here as
spans (:meth:`Stopwatch.span`), which also land in a ``torch.profiler``
trace, beside the device's operations, while a profiler records; device time
per stage is ``core.pipeline.StageTimer``'s (CUDA events).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler


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
    """tic()/toc() stack + named spans with aggregated statistics."""

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
        if elapsed > s.max:
            s.max = elapsed
        s.last = elapsed

    def toc(self, label: Optional[str] = None) -> float:
        elapsed = time.perf_counter() - self._stack.pop()
        if label is not None:
            self.record(label, elapsed)
        return elapsed

    def span(self, label: str) -> "_Span":
        """Timed scope whose lap is recorded under ``label`` (the body may
        set ``.label`` on the object it gets, to name the lap by what
        happened). While a ``torch.profiler`` records, the scope is also a
        ``record_function(label)`` around the body, opened under the label
        it started with; otherwise nothing but the two clock reads."""
        return _Span(self, label)

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


class _Span:
    """:meth:`Stopwatch.span`'s context: the host-clock lap, and inside it
    the profiler's range when one records."""

    __slots__ = ("_sw", "label", "_t0", "_range")

    def __init__(self, sw: Stopwatch, label: str):
        self._sw = sw
        self.label = label

    def __enter__(self) -> "_Span":
        # the lap holds the range, its opening and closing included: a
        # span's lap then lies inside the range of the span around it
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.label)
            self._t0 = time.perf_counter()
            self._range.__enter__()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self._sw.record(self.label, time.perf_counter() - self._t0)
        return False


class _NoSpan:
    """The scope of no stopwatch: it times nothing, and takes a ``label``
    that nothing reads."""

    __slots__ = ("label",)

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(stopwatch: Optional[Stopwatch], label: str):
    """``stopwatch.span(label)``, or a scope that does nothing where there
    is no stopwatch (``None``)."""
    return _NO_SPAN if stopwatch is None else stopwatch.span(label)
