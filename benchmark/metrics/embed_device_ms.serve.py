"""Device milliseconds of the kernels launched inside the service's
"embed" range (``infer/serve.py``), per request, in the traced part of the
open loop."""


def read(ctx):
    embed_ms = ctx.get("summary", {}).get("phases", {}).get("embed")
    if not embed_ms or not ctx.get("embed_ranges"):
        return None
    return embed_ms / ctx["embed_ranges"]
