"""The share (%) of the traced window in which the card ran no kernel while
the host was outside every ``train_step`` range: the feed, the loss reads
and the loop around the step (``spans.idle_outside``). The rest of
``idle_share.train`` fell inside the step."""

from benchmark.spans import idle_outside


def read(ctx):
    return idle_outside(ctx.get("trace"), "train_step", ctx.get("window_s"))
