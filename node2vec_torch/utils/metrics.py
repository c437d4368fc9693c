"""Step-time metrics and profiler hooks (port of
``node2vec_tpu/utils/metrics.py``).

``StepTimer`` collects named wall times on the host clock and derives
throughput; the trainers and the walk engine record into one when given
``timer=``.  A region's time is host wall time, as in the JAX package: it
ends where the host code of the region ends, which waits for the card only
where that code reads a result back (an epoch's loss, a fetched chunk).
``profiler_trace`` wraps a block in a ``torch.profiler`` trace and writes
it to ``log_dir`` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional


class StepTimer:
    """Collects named step durations and derived throughput."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.times.get(name, []))

    def mean(self, name: str) -> float:
        ts = self.times.get(name, [])
        return sum(ts) / len(ts) if ts else 0.0

    def count(self, name: str) -> int:
        return len(self.times.get(name, []))

    def throughput(self, name: str, units_per_step: float) -> float:
        """units/second for a step kind, excluding the first call (which
        builds the kernels and warms the caches)."""
        ts = self.times.get(name, [])
        if not ts:
            return 0.0
        steady = ts[1:] if len(ts) > 1 else ts
        total = sum(steady)
        return (units_per_step * len(steady) / total) if total > 0 else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"count": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
            for k, v in self.times.items()
        }


def measure(timer: Optional[StepTimer], name: str):
    """``timer.measure(name)``, or a context that records nothing."""
    return timer.measure(name) if timer is not None else contextlib.nullcontext()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """torch.profiler trace (host and, on the card, CUDA activity) of the
    enclosed block, written to ``log_dir/trace.json`` as a Chrome trace; a
    no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
