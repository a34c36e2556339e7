"""The share (%) of the traced window in which the card ran no kernel
(``readers.idle_share``)."""

from benchmark.readers import idle_share as read  # noqa: F401
