"""The share (%) of the traced window in which the card ran no kernel while
the host was outside every ``slide_step`` range: the slide's generator, the
loss read after every step and the loop (``spans.idle_outside``). The rest
of ``idle_share.small_slide`` fell inside the step."""

from benchmark.spans import idle_outside


def read(ctx):
    return idle_outside(ctx.get("trace"), "slide_step", ctx.get("window_s"))
