"""The step's model FLOP/s over the untraced part of the window, as a share
(%) of the H100's dense TF32 peak (``readers.mfu``)."""

from benchmark.readers import mfu as read  # noqa: F401
