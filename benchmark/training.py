"""What the training drivers share: the measured window, the readings of
the first steps and their comparison with the reference.

The comparison follows the first ``checked`` steps of the program's own
train state, driven from the seed through the window's own step call and
feed, on rows that all differ: each step's loss, the norm of each leaf's
first gradient as Adam took it (its first moment after one step, divided
by 1 - beta1: the weight decay is in it), and the norm of each leaf's
change after the checked steps. Gaps are taken leaf by leaf, as the gap
between the two norms over the larger of the reference's norm of that leaf
and of the median leaf. A leaf whose reference gradient is under a
thousandth of the median leaf's moves under Adam by round-off alone; it is
left out of the change's comparison.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark.trace import Traced, breakdown, summarize

BETA1 = 0.9
NEGLIGIBLE_GRAD = 1e-3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def parameters(state) -> Dict[str, torch.Tensor]:
    return dict(state.model.named_parameters())


def first_gradients(state) -> Dict[str, float]:
    """Each leaf's gradient norm as Adam took it at its first step."""
    opt = state.optimizer
    return {k: float(opt.state[p]["exp_avg"].norm()) / (1.0 - BETA1)
            for k, p in parameters(state).items()}


def changes(state, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float((p.detach() - start[k]).norm()) for k, p in parameters(state).items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    scale = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], scale) for k in keys}


def readings(prog: dict, ref: dict) -> dict:
    """The numbers a check may compare: ``loss_gap`` (the largest of the
    steps' |loss - reference| / |reference|), ``grad_gap`` and
    ``change_gap`` (the worst leaf's gap of norms, the leaf named in
    ``*_worst``) and ``grad_gap_median`` (the median leaf's gap)."""
    keys = sorted(ref["grad_norms"])
    median_grad = statistics.median(ref["grad_norms"][k] for k in keys)
    moved = [k for k in keys if ref["grad_norms"][k] >= NEGLIGIBLE_GRAD * median_grad]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))}
    for name, keys_of in (("grad", keys), ("change", moved)):
        gaps = leaf_gaps(prog[f"{name}_norms"], ref[f"{name}_norms"], keys_of)
        worst = max(gaps, key=gaps.get)
        out.update({f"{name}_gap": gaps[worst], f"{name}_worst": worst})
        if name == "grad":
            out["grad_gap_median"] = statistics.median(gaps.values())
    return out


def checked_steps(state, run_step: Callable[[int], torch.Tensor], n: int) -> dict:
    """Run the program's first ``n`` steps (``run_step(i)`` returns the
    loss) and read them."""
    start = {k: p.detach().clone() for k, p in parameters(state).items()}
    losses, grads = [], None
    for i in range(n):
        losses.append(float(run_step(i)))
        if i == 0:
            grads = first_gradients(state)
    out = {"losses": losses, "grad_norms": grads, "change_norms": changes(state, start)}
    del start
    return out


@dataclasses.dataclass
class Step:
    """What one window step did: its work ``units`` (spots), its model
    ``flops``, its loss tensor, and what a metric reader may need of it."""

    units: int
    flops: float
    loss: torch.Tensor
    meta: Optional[dict] = None


@dataclasses.dataclass
class Window:
    steps: List[Step]
    elapsed: float
    traced: List[Step]
    trace: Optional[dict]
    trace_window_s: Optional[float]
    trace_cost_s: float  # the traced steps' host time, the profiler's start and stop in it
    nonfinite: int


def run_window(seconds: float, step: Callable[[int], Step], device, read_every: int,
               trace_path: Optional[Path] = None, trace_steps: int = 0) -> Window:
    """Steps from ``step(0)`` on until ``seconds`` have passed, then a
    synchronize. Losses are read every ``read_every`` steps, as the
    program's loop reads them. With ``trace_path``, ``trace_steps`` steps
    from a third of the window on run under the profiler."""
    steps, traced, pending, nonfinite = [], [], [], 0
    tracer, trace, trace_window, trace_cost = None, None, None, 0.0
    t0 = time.perf_counter()
    i = 0
    while True:
        if trace_path and tracer is None and trace is None and \
                time.perf_counter() - t0 >= seconds / 3:
            trace_cost = -time.perf_counter()
            tracer = Traced(trace_path, torch.device(device).type).start()
        s = step(i)
        (traced if tracer is not None else steps).append(s)
        pending.append(s.loss)
        if (i + 1) % read_every == 0:
            nonfinite += sum(not torch.isfinite(v).item() for v in pending)
            pending.clear()
        if tracer is not None and len(traced) == trace_steps:
            trace = tracer.stop().collect()
            trace_window, tracer = tracer.window_s, None
            trace_cost += time.perf_counter()
        i += 1
        if time.perf_counter() - t0 >= seconds and tracer is None:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    nonfinite += sum(not torch.isfinite(v).item() for v in pending)
    return Window(steps, elapsed, traced, trace, trace_window, trace_cost, nonfinite)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def layer_context(w: Window, phases) -> dict:
    """What the per-layer readers read of a training window: the model
    operations and host seconds of its untraced steps, and of the traced
    ones the trace, its summary and each step's ``meta``."""
    ctx = {"work_flops": sum(s.flops for s in w.steps), "work_s": w.elapsed - w.trace_cost_s}
    if w.trace is not None:
        summary = summarize(w.trace, len(w.traced), phases)
        ctx.update(trace=w.trace, summary=summary, busy_s=summary["busy_s"],
                   window_s=w.trace_window_s, traced=[s.meta for s in w.traced],
                   breakdown=breakdown(w.trace))
    return ctx
