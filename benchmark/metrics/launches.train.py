"""Kernels launched inside the train step's ``train_step`` range
(``train/step.py``), per traced step: the feed's gathers and draws and the
loop's loss reads fall outside it (``spans.launches_per_range``)."""

from benchmark.spans import launches_per_range


def read(ctx):
    return launches_per_range(ctx.get("trace"), "train_step")
