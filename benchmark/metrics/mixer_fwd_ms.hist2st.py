"""Device ms per traced step of the kernels launched inside Hist2ST's
``convmixer`` ranges (``baselines/models.py::Hist2ST.forward``: the
patchify, its dropout, the ConvMixer blocks and ``down``), over the step's
six passes (``span_time.device_ms_per_step``). Forward only: autograd's
thread launches the backward outside the range."""

from benchmark.span_time import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx.get("trace"), "convmixer", len(ctx.get("traced") or ()))
