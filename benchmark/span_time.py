"""Device time of the kernels that the program launches inside its own
``record_function`` ranges, from a ``torch.profiler`` trace.

A kernel belongs to a range by the time of its launch, a CUDA runtime call
or a ``cuLaunchKernel`` (through which cuBLAS launches its gemms), tied to
the kernel by its correlation id (``spans.LAUNCH_CATS``), whatever thread
made it. Nested or repeated ranges of one name count each
kernel once. A reader returns None where the trace holds no range of the
name (a program that names none) or no kernel (a run on the CPU).
"""

from __future__ import annotations

import bisect
from typing import Optional

from benchmark.spans import LAUNCH_CATS, ranges, union
from benchmark.trace import kernels_of


def device_ms_per_step(trace: Optional[dict], name: str, steps: int) -> Optional[float]:
    """The device ms of the kernels launched inside ranges called ``name``,
    over ``steps`` traced steps."""
    spans = ranges(trace, name) if trace else []
    kernels = kernels_of(trace) if trace else []
    if not spans or not kernels or steps <= 0:
        return None
    covered = union(spans)
    starts = [s for s, _ in covered]
    launch = {e["args"]["correlation"]: e["ts"] for e in trace["traceEvents"]
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    us = 0.0
    for k in kernels:
        t = launch.get(k["args"].get("correlation"))
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= covered[i][1]:
            us += k["dur"]
    return us * 1e-3 / steps
