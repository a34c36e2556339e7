"""Running meters and timers (reference ``utils.py:1-16`` AvgMeter, plus the
step-time/throughput instrumentation the reference lacks — SURVEY §5)."""

from __future__ import annotations

import time


class AvgMeter:
    def __init__(self, name: str = "Metric"):
        self.name = name
        self.reset()

    def reset(self):
        self.avg, self.sum, self.count = 0.0, 0.0, 0

    def update(self, val: float, count: int = 1):
        self.count += count
        self.sum += val * count
        self.avg = self.sum / self.count

    def __repr__(self):
        return f"{self.name}: {self.avg:.4f}"


class Stopwatch:
    """Wall-clock throughput meter: items/sec over update() calls."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self.items = 0

    def update(self, n: int):
        self.items += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    @property
    def rate(self) -> float:
        dt = self.elapsed
        return self.items / dt if dt > 0 else 0.0
