"""Hist2ST's step: the model FLOP/s of the untraced part of the window
(``configs/hist2st.py::slide_flops``), as a share (%) of the H100's dense
TF32 peak (``readers.mfu``)."""

from benchmark.readers import mfu as read  # noqa: F401
