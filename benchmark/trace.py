"""Device time from a ``torch.profiler`` trace of a part of the window.

``category``, ``union_us`` and ``summarize`` are a frozen copy of
``mclstexp_tpu_torch/profile_step.py`` (device time by ``record_function``
range, kernel family and kernel from a Chrome trace); ``breakdown`` adds the
longest device operations and the idle gaps, named by what the host was
doing when it launched the kernel that ended each gap.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
import time
from pathlib import Path

# First match wins: cuDNN's batch-norm and convolution kernels share the
# "cudnn" prefix, and its convolutions also carry "gemm" in their names.
CATEGORIES = (
    ("flash", r"flash_"),
    ("row_shift", r"shift_rows|shift_cols"),
    ("batch_norm", r"batch_norm|batchnorm|bn_fw|bn_bw|welford"),
    ("layout_transpose", r"nchwToNhwc|nhwcToNchw"),
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit"),
    ("matmul", r"gemm|cutlass|cublas|splitK"),
    ("optimizer", r"multi_tensor|adam"),
    ("copy_cat", r"[Cc]at|[Cc]opy"),
    ("reduce", r"reduce|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def kernels_of(trace: dict) -> list:
    return [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]


def summarize(trace: dict, steps: int, phases=()) -> dict:
    """Device time by phase (the ``record_function`` ranges named in
    ``phases``), category and kernel from a Chrome trace."""
    events = trace["traceEvents"]
    kernels = kernels_of(trace)
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in phases]
    phase_us = collections.Counter()
    cat_us = collections.Counter()
    name_us, name_n = collections.Counter(), collections.Counter()
    for k in kernels:
        t = launches.get(k["args"].get("correlation"))
        phase = next((n for n, s, e in ranges if t is not None and s <= t <= e), "outside")
        phase_us[phase] += k["dur"]
        cat_us[category(k["name"])] += k["dur"]
        name_us[k["name"]] += k["dur"]
        name_n[k["name"]] += 1
    busy = union_us((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    window = (max(k["ts"] + k["dur"] for k in kernels) - min(k["ts"] for k in kernels)
              if kernels else 0.0)
    per = 1e-3 / max(steps, 1)
    return {
        "device_busy_ms_per_step": busy * per,
        "window_ms_per_step": window * per,
        "kernels_per_step": len(kernels) / max(steps, 1),
        "phases": {p: phase_us[p] * per for p in (*phases, "outside") if p in phase_us},
        "categories": {c: u * per for c, u in cat_us.most_common()},
        "top_kernels": [{"name": n[:120], "ms_per_step": u * per, "launches_per_step":
                         name_n[n] / max(steps, 1)} for n, u in name_us.most_common(15)],
        "busy_s": busy * 1e-6,
    }


def _innermost(ops_by_tid: dict, tid, t: float) -> str:
    """The name of the innermost host op on thread ``tid`` running at ``t``."""
    starts, ops = ops_by_tid.get(tid, ((), ()))
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        name, s, e = ops[j]
        if e >= t:
            return name
    return "host"


def breakdown(trace: dict) -> dict:
    """The ``TOP`` kernels by device seconds, and the idle gaps between
    kernels summed by the host op that launched the kernel after each gap."""
    events = trace["traceEvents"]
    kernels = sorted(kernels_of(trace), key=lambda k: k["ts"])
    by_name = collections.Counter()
    for k in kernels:
        by_name[k["name"][:100]] += k["dur"] * 1e-6
    launch = {e["args"]["correlation"]: (e.get("tid"), e["ts"]) for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    host = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in HOST_CATS and "dur" in e:
            host[e.get("tid")].append((e["name"][:100], e["ts"], e["ts"] + e["dur"]))
    ops_by_tid = {}
    for tid, ops in host.items():
        ops.sort(key=lambda o: o[1])
        ops_by_tid[tid] = ([o[1] for o in ops], ops)
    gaps = collections.Counter()
    end = None
    for k in kernels:
        if end is not None and k["ts"] > end:
            where = launch.get(k["args"].get("correlation"))
            name = _innermost(ops_by_tid, *where) if where else "host"
            gaps[name] += (k["ts"] - end) * 1e-6
        end = k["ts"] + k["dur"] if end is None else max(end, k["ts"] + k["dur"])
    return {"device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}


class Traced:
    """``torch.profiler`` (the host ops of the thread that starts it, and
    every kernel of the card) from ``start()`` to ``stop()``, each after a
    synchronize; ``window_s`` is the host time between the two, and
    ``collect()`` the Chrome trace."""

    def __init__(self, path: Path, device: str = "cuda"):
        self.path, self.device = Path(path), device
        self.trace, self.window_s = None, None

    @staticmethod
    def warm(path: Path, device: str = "cuda") -> None:
        """Start and stop the profiler once, in set-up: its first start takes
        seconds, which would otherwise fall inside the window."""
        Traced(path, device).start().stop().collect()

    def _sync(self):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()

    def start(self) -> "Traced":
        import torch
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU]
        if self.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> "Traced":
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return self

    def collect(self) -> dict:
        """The Chrome trace (exported and read back: seconds for a busy
        window, so a driver collects it where it delays no request)."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            self.trace = json.load(f)
        self.path.unlink()
        return self.trace
