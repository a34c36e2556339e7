"""The program's own ``record_function`` ranges in a ``torch.profiler`` trace:
the kernels launched inside them, and the card's idle time outside them.

A range is a "user_annotation" event on the thread that ran it; a kernel's
launch is a CUDA runtime call (or a `cuLaunchKernel`), tied to the kernel by its
correlation id. Both lie on the kernels' clock. A launch belongs to a range
by its time, whatever thread made it: a step's backward kernels are
launched by the autograd engine's own thread while the step's thread waits
inside ``loss.backward()``. A reader returns None where the trace holds no
range of the name (a program that names none) or no kernel (a run on the
CPU).
"""

from __future__ import annotations

import bisect
from typing import Optional

from benchmark.trace import kernels_of

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def ranges(trace: dict, name: str) -> list:
    """(start, end) of every range called ``name``, in µs."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e]


def launches_per_range(trace: Optional[dict], name: str) -> Optional[float]:
    """The kernels whose launch lies inside a range called ``name``, over
    the number of such ranges."""
    spans = ranges(trace, name) if trace else []
    kernels = kernels_of(trace) if trace else []
    if not spans or not kernels:
        return None
    covered = union(spans)
    starts = [s for s, _ in covered]
    launch = {e["args"]["correlation"]: e["ts"] for e in trace["traceEvents"]
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    n = 0
    for k in kernels:
        t = launch.get(k["args"].get("correlation"))
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t <= covered[i][1]
    return n / len(spans)


def union(intervals) -> list:
    """The disjoint, sorted union of ``intervals`` ((start, end) pairs)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two disjoint, sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_outside(trace: Optional[dict], name: str, window_s: Optional[float]) -> Optional[float]:
    """The share (%) of ``window_s`` in which no kernel ran while the host
    was outside every range called ``name``: the gaps between the trace's
    kernels, less the parts of them that such a range covers. The gaps lie
    between the first kernel's start and the last one's end, so the share
    never exceeds the idle share of the same window."""
    spans = ranges(trace, name) if trace else []
    kernels = kernels_of(trace) if trace else []
    if not spans or not kernels or not window_s:
        return None
    busy = union((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle_us = sum(e - s for s, e in gaps)
    inside_us = overlap(gaps, union(spans))
    return 100.0 * (idle_us - inside_us) * 1e-6 / window_s

