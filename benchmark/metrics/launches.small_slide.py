"""Kernels launched inside the slide step's ``slide_step`` range
(``baselines/trainer.py::make_slide_step``), per traced step
(``spans.launches_per_range``)."""

from benchmark.spans import launches_per_range


def read(ctx):
    return launches_per_range(ctx.get("trace"), "slide_step")
