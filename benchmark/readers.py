"""Arithmetic that several per-layer readers share. A reader returns None
where its cell's run gave it nothing to read; never 0 for a share."""

from __future__ import annotations

from typing import Optional

from benchmark.harness import load_module
from benchmark.trace import category, kernels_of


def mfu(ctx: dict) -> Optional[float]:
    """The model operations of the window's untraced steps over their host
    seconds, as a share (%) of the card's TF32 tensor-core peak."""
    if not ctx.get("work_flops") or not ctx.get("work_s"):
        return None
    return 100.0 * ctx["work_flops"] / ctx["work_s"] / ctx["peaks"]["tf32_flops_per_s"]


def idle_share(ctx: dict) -> Optional[float]:
    """The share (%) of the traced window in which no kernel ran."""
    if not ctx.get("window_s") or not ctx.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def flash_roofline(ctx: dict) -> Optional[float]:
    """The fp32 flash-attention kernels' share (%) of their roofline in the
    traced slide steps: the least time their operations and bytes allow
    (``kernels/flash.py``), summed over each step's attention calls, over the
    device time of the kernels named ``flash_`` in the trace."""
    if ctx.get("trace") is None:
        return None
    flash = load_module("kernels", "flash")
    spent = sum(k["dur"] for k in kernels_of(ctx["trace"]) if category(k["name"]) == "flash")
    if not spent:
        return None
    bound = 0.0
    for meta in ctx["traced"]:
        count, (b, h, n, d), real = ctx["builder"].attention_calls(ctx["config"], meta["spots"])
        bound += count * flash.bound_s(b, h, n, d, real, ctx["peaks"])
    return 100.0 * bound / (spent * 1e-6)
