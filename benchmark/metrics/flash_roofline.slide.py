"""The fp32 flash-attention kernels' share (%) of their roofline in the
traced steps of the whole slide (``readers.flash_roofline``)."""

from benchmark.readers import flash_roofline as read  # noqa: F401
