"""Wall-clock timing helpers used by benchmarks and the online autotuner."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class Timer:
    """Context manager measuring wall time in seconds."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.start


@dataclass
class Stopwatch:
    """Accumulates named durations; used for phase breakdowns in benches."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / c if c else 0.0

    def summary(self) -> dict:
        return {k: (self.totals[k], self.counts[k]) for k in sorted(self.totals)}
