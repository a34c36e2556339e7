"""The fp32 flash-attention kernels' share (%) of their roofline in the
traced steps of Hist2ST's whole slide, 48 calls a step
(``readers.flash_roofline``)."""

from benchmark.readers import flash_roofline as read  # noqa: F401
