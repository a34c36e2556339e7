"""The fp32 flash-attention kernels' share (%) of their roofline in the
traced steps of the her2st-sized slides (``readers.flash_roofline``)."""

from benchmark.readers import flash_roofline as read  # noqa: F401
