"""Device ms per traced step of the kernels launched inside Hist2ST's ``jknet``
ranges (``baselines/models.py::Hist2ST.forward``: the jump-knowledge LSTM
and its mean over depth), over the step's six passes
(``span_time.device_ms_per_step``). Forward only: autograd's thread launches
the backward outside the range."""

from benchmark.span_time import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx.get("trace"), "jknet", len(ctx.get("traced") or ()))
