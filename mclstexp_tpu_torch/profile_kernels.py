"""Device times of the port's kernels at the inputs the main path gives them.

    python -m mclstexp_tpu_torch.profile_kernels [--only flash]

* ``row_shift`` at the flagship (128, 224, 224, 3), float32 and bfloat16,
  in its row layout (a contiguous image: the Paeth row shears) and its
  column layout (the (1, 2)-transposed view: the column shear), at two
  shift inputs: uniform random shifts in [-W, W] with the clamp edges
  (``random_shifts``), and the shifts the Paeth rotation computes for 128
  angles drawn as ``augment.sample_st_draws`` draws them (``paeth_shifts``:
  ``shear_x`` for the rows, ``shear_y`` for the column shear);
* ``extract_patches`` on a 20,000 x 20,000 x 3 uint8 slide (a Visium
  full-resolution image) with 4,992 grid centers and 64 at and past its
  border (``patch_centers``), P = 224;
* the three flash kernels (the forward without and with residuals, dK/dV,
  dQ) in float32 and in bfloat16 on the views of one qkv buffer at
  ``FLASH_SHAPES`` (the flagship's eval sweep, training, remainder and
  ragged lengths, the slide baselines' 768 and 4,096 rows), without segment
  ids and, where the package's kernels take them, with them (the last 63
  rows padded), by graph replays below n = 4,096 and by events over eager
  launches at it (``time_flash``), each with the fp32 plan's design and the
  training call's pair (forward with residuals, then dK/dV and dQ as
  ``FlashAttention`` runs them: one split pass for both on the warpgroup
  design); the fp32 pair on both designs at ``CROSSOVER`` shapes
  (``time_designs``: where ``fp32_plan`` switches); and the fp32 dK/dV with
  segment ids on 64-key and on 128-key CTAs at ``DKV_CROSSOVER`` shapes
  (``time_dkv_designs``: where ``fp32_plan`` gives dK/dV 128 keys a CTA).
  ``--only flash`` times these alone;
* the fp32 linear maps (``ops.linear``) at ``LINEAR_SHAPES`` (HisToGene's
  products at 4,096 rows): the 3xTF32 kernel's forward, dX and dW (each
  with its split pass) and its whole backward (dX, dW, db), against cuBLAS
  in fp32 (the plain version) and with TF32 allowed, each with its error
  against float64 (``time_linear``); and a layer's forward and backward on
  each side of ``linear_plan``'s crossover (``LINEAR_CROSSOVER``,
  ``time_linear_designs``): device ms, and the ms of an eager call, host
  included. ``--only linear`` times these alone.

Each data-movement case is checked bit-equal to the plain version (the
flash and linear kernels are checked by the card tests,
``tests/test_torch_port_*.py -m gpu``) and timed two ways: ``ms``, CUDA
events over eager launches (the wrapper's host cost included when it
exceeds the kernel's time), and ``graph_ms``, CUDA-graph replays (device
time alone). Prints one JSON object with the card's name and power limit.
To compare a parent commit in one chip call, unpack it into
``build/parent``, copy this file into its package and run parent, change,
change, parent.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import time

import numpy as np
import torch

from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops import flash_attention as fa
from mclstexp_tpu_torch.ops import linear as lin
from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_plain
from mclstexp_tpu_torch.ops.row_shift import row_shift, row_shift_plain

FLAGSHIP = (128, 224, 224, 3)  # the Paeth shears' images at the her2st widths
I32_MIN = -2**31
VISIUM_SIDE = 20_000  # a Visium full-resolution image.tif is about 20,000-25,000 px a side
PATCH = 224
FLASH_SHAPES = ((1, 8, 32, 64), (1, 8, 66, 64), (1, 8, 128, 64), (1, 8, 300, 64),
                (1, 16, 384, 64), (1, 16, 768, 64), (1, 16, 4096, 64))
# around the fp32 plan's crossover: the slide baselines' 16 heads, the flagship's 8
CROSSOVER = tuple((1, 16, n, 64) for n in (128, 256, 320, 384, 512, 768)) + tuple(
    (1, 8, n, 64) for n in (300, 512, 640, 1024))
# around the crossover of the warpgroup dK/dV's two designs (64 or 128 keys a CTA): 48 to
# 512 CTAs of 128 keys
DKV_CROSSOVER = tuple((1, 16, n, 64) for n in (384, 512, 576, 768, 1024, 1152, 2048, 4096)) + (
    (1, 8, 1024, 64), (1, 8, 1088, 64), (1, 16, 4096, 32))
FLASH_PADDED = 63  # rows of the padded tail in the segment-id case
# (m, n, k): HisToGene's patch embedding, qkv, out, MLP up and down, gene head
LINEAR_SHAPES = ((4096, 1024, 37632), (4096, 3072, 1024), (4096, 1024, 1024),
                 (4096, 2048, 1024), (4096, 1024, 2048), (4096, 785, 1024))
LINEAR_CROSSOVER = tuple((m, n, k) for m in (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)
                         for n, k in ((3072, 1024), (1024, 1024), (1024, 2048)))
TF32_FLOPS = 495e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """ms per call of ``fn`` by CUDA events around ``iters`` eager calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Host ms per call of ``fn``: the host's clock around ``iters`` eager
    calls that queue their work without waiting for it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e3


def graph_ms(fn, reps: int = 20, iters: int = 20) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``iters`` times, so that the host's cost of launching
    (which dominates a call of a few microseconds) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def random_shifts(g, b, h, w):
    """(b, h) int32 shifts uniform in [-w, w], the clamp edges +-w//2 and
    values beyond them first."""
    k = torch.randint(-w, w + 1, (b, h), generator=g, device="cuda", dtype=torch.int32)
    edges = torch.tensor([0, w // 2, -(w // 2), w // 2 + 1, -(w // 2) - 1, w, -w, 3 * w],
                         device="cuda", dtype=torch.int32)
    k.view(-1)[: len(edges)] = edges
    return k


def paeth_shifts(g, b, size):
    """(shear_x, shear_y), each (b, size) int32: the row and column shears
    of the Paeth rotation for b angles drawn as the "st" augmentation draws
    them."""
    _, shear_x, shear_y = augment.paeth_shears(augment.sample_st_draws(g, b, "cuda").angles,
                                               size)
    return shear_x, shear_y


def shift_inputs(g, dtype):
    """{(layout, shifts name): (view, shifts)} at the flagship shape: the
    contiguous image for "rows", its transposed view for "cols"."""
    b, h, w, _ = FLAGSHIP
    x = torch.rand(FLAGSHIP, generator=g, device="cuda").to(dtype)
    k = random_shifts(g, b, h, w)
    shear_x, shear_y = paeth_shifts(g, b, h)
    return {("rows", "random"): (x, k), ("cols", "random"): (x.transpose(1, 2), k),
            ("rows", "paeth"): (x, shear_x), ("cols", "paeth"): (x.transpose(1, 2), shear_y)}


def time_row_shift(view, k) -> dict:
    """``row_shift`` on (view, k): bit-equal to ``row_shift_plain`` (raises
    otherwise), then timed: events over eager calls and graph replays."""
    got, want = row_shift(view, k), row_shift_plain(view, k)
    torch.cuda.synchronize()
    if got.stride() != view.stride() or not torch.equal(got, want):
        raise AssertionError(f"row_shift {tuple(view.stride())} {view.dtype} differs from its "
                             "plain version")
    return {"ms": cuda_ms(lambda: row_shift(view, k)),
            "graph_ms": graph_ms(lambda: row_shift(view, k))}


def patch_centers(side: int):
    """4,992 centers on a grid inside a side x side slide (78 x 64, 250 px
    apart: no two patches overlap) and 64 at and past its border, two of them
    a missing spot's floor(NaN) = -2147483648."""
    gx, gy = np.meshgrid(250 + 250 * np.arange(78), 250 + 300 * np.arange(64))
    inside = np.stack([gx.ravel(), gy.ravel()], axis=1)
    past = np.array([0, -1, -50, -111, -112, -113, -224, -300, -5000, side - 1, side,
                     side + 111, side + 112, side + 300, side + 5000, I32_MIN])
    along = np.linspace(0, side - 1, 16).astype(np.int64)
    edge = np.concatenate([np.stack([past, along], 1), np.stack([along, past], 1),
                           np.stack([past[::-1], along[::-1]], 1),
                           np.stack([along[::-1], past], 1)])
    return np.concatenate([inside, edge]).astype(np.int64)


def patch_bytes(centers, side: int, patch: int, channels: int) -> int:
    """Bytes the crop must move: every output byte written once, the
    in-slide part of every patch read once, and the centers."""
    r = patch // 2
    c = centers.astype(np.int64)
    span = [np.clip(np.minimum(c[:, k] + r, side) - np.maximum(c[:, k] - r, 0), 0, None)
            for k in (0, 1)]
    return int((span[0] * span[1]).sum() * channels + len(c) * patch * patch * channels
               + c.size * 8)


def patch_input(g):
    """(slide, host centers, card centers) of the full-size patch case."""
    slide = torch.randint(0, 256, (VISIUM_SIDE, VISIUM_SIDE, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
    host = patch_centers(VISIUM_SIDE)
    return slide, host, torch.from_numpy(host).cuda()


def time_patches(slide, centers) -> dict:
    """``extract_patches`` at P = 224: bit-equal to ``extract_patches_plain``
    (raises otherwise), then timed: events over eager calls and graph
    replays (a graph of 4 calls: each holds its 760 MB output)."""
    got, want = extract_patches(slide, centers, PATCH), extract_patches_plain(slide, centers,
                                                                            PATCH)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("extract_patches at full size differs from its plain version")
    del got, want
    return {"ms": cuda_ms(lambda: extract_patches(slide, centers, PATCH), iters=10, warmup=2),
            "graph_ms": graph_ms(lambda: extract_patches(slide, centers, PATCH), reps=4,
                                 iters=5)}


def flash_case(shape, g, segments: bool, dtype=torch.float32):
    """(q, k, v, do, ids, l, m, di, scale) at ``shape`` in ``dtype``: q, k, v
    the views of one qkv buffer, ``ids`` () or (segment ids with the last
    ``FLASH_PADDED`` rows padded,), l, m and di from the forward kernel."""
    b, h, n, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, n, d), generator=g, device="cuda").to(dtype)
    scale = d**-0.5
    ids = ((torch.arange(n, device="cuda") < n - FLASH_PADDED).to(torch.int32)[None]
           .expand(b, n).contiguous(),) if segments else ()
    out, l, m = fa.flash_forward(q, k, v, scale, True, *ids)
    di = (out.float() * do.float()).sum(-1).contiguous()
    return q, k, v, do, ids, l, m, di, scale


def flash_timer(n: int):
    """Events over eager calls at n >= 4,096, graph replays below."""
    return (lambda fn: cuda_ms(fn, iters=10, warmup=2)) if n >= 4096 else graph_ms


def time_flash(shape, g, segments: bool, dtype=torch.float32) -> dict:
    """ms per call of the flash forward (without and with residuals), dK/dV
    and dQ at ``shape`` in ``dtype`` on the views of one qkv buffer, with
    segment ids (the last ``FLASH_PADDED`` rows padded) or without."""
    q, k, v, do, ids, l, m, di, scale = flash_case(shape, g, segments, dtype)
    timed = flash_timer(shape[2])

    def pair():
        o, ll, mm = fa.flash_forward(q, k, v, scale, True, *ids)
        dd = (o.float() * do.float()).sum(-1).contiguous()
        fa.flash_backward(q, k, v, do, ll, mm, dd, scale, *ids)

    return {"design": fa.fp32_plan(*shape)[0] if dtype == torch.float32 else None,
            "fwd": timed(lambda: fa.flash_forward(q, k, v, scale, False, *ids)),
            "fwd_res": timed(lambda: fa.flash_forward(q, k, v, scale, True, *ids)),
            "bwd_dkv": timed(lambda: fa.flash_bwd_dkv(q, k, v, do, l, m, di, scale, *ids)),
            "bwd_dq": timed(lambda: fa.flash_bwd_dq(q, k, v, do, l, m, di, scale, *ids)),
            "pair": timed(pair)}


def time_designs(shape, g) -> dict:
    """Device ms of the fp32 training pair with segment ids at ``shape`` on
    each design, the plan's crossover moved out of the way for the one it
    would not pick (``time_flash``'s "pair")."""
    limits = fa.WG_MIN_N, fa.WG_MIN_CTAS
    out = {}
    try:
        for design, (min_n, min_ctas) in (("warpgroup", (1, 1)), ("cluster", (2**31, 2**31))):
            fa.WG_MIN_N, fa.WG_MIN_CTAS = min_n, min_ctas
            out[design] = time_flash(shape, g, True)["pair"]
    finally:
        fa.WG_MIN_N, fa.WG_MIN_CTAS = limits
    out["plan"] = fa.fp32_plan(*shape)[0]
    return out


def time_dkv_designs(shape, g) -> dict:
    """ms of the fp32 dK/dV with segment ids at ``shape`` (with its split
    pass, as ``time_flash``'s "bwd_dkv") on 64-key and on 128-key CTAs, the
    plan's threshold moved out of the way for the one it would not pick; the
    128-key design's CTAs and the keys a CTA the plan picks."""
    q, k, v, do, ids, l, m, di, scale = flash_case(shape, g, True)
    b, h, n, _ = shape
    limit = fa.WG128_MIN_CTAS
    out = {"ctas128": b * h * -(-n // fa.WG128_ROWS)}
    try:
        for design, minimum in (("keys64", 2**31), ("keys128", 1)):
            fa.WG128_MIN_CTAS = minimum
            out[design] = flash_timer(n)(
                lambda: fa.flash_bwd_dkv(q, k, v, do, l, m, di, scale, *ids))
    finally:
        fa.WG128_MIN_CTAS = limit
    out["plan"] = fa.fp32_plan(*shape)[4]
    return out


def _rel_err(x, exact) -> float:
    return (torch.linalg.norm((x.double() - exact).flatten())
            / torch.linalg.norm(exact.flatten())).item()


def time_linear(shape, g) -> dict:
    """Device ms and float64 errors of y = x w^T + b at (m, n, k): the
    kernel's forward, dX and dW (each with its split pass) and its whole
    backward (dX, dW, db); cuBLAS fp32 (``F.linear``, the plain version) and
    cuBLAS with TF32 allowed, the same; the 3xTF32 bound of one product."""
    m, n, k = shape
    x = torch.randn((m, k), generator=g, device="cuda")
    w = (torch.rand((n, k), generator=g, device="cuda") * 2 - 1) * k**-0.5
    b = torch.randn((n,), generator=g, device="cuda")
    dy = torch.randn((m, n), generator=g, device="cuda")
    f = torch.nn.functional.linear
    exact = (f(x.double(), w.double(), b.double()), dy.double() @ w.double(),
             dy.double().T @ x.double())
    timed = lambda fn: graph_ms(fn, reps=5, iters=5)  # noqa: E731
    kernel = {"": lambda: lin._forward(x, w, b), "_dx": lambda: lin._backward(x, w, dy, True,
                                                                              False)[0],
              "_dw": lambda: lin._backward(x, w, dy, False, True)[1]}
    library = {"": lambda: f(x, w, b), "_dx": lambda: dy @ w, "_dw": lambda: dy.T @ x}
    out = {"bound": 3 * 2 * m * n * k / TF32_FLOPS * 1e3,
           "backward": timed(lambda: (lin._backward(x, w, dy, True, True), dy.sum(0))),
           "cublas_backward": timed(lambda: (dy @ w, dy.T @ x, dy.sum(0)))}
    for (part, fn), want in zip(kernel.items(), exact):
        out["kernel" + part], out["err_kernel" + part] = timed(fn), _rel_err(fn(), want)
    for (part, fn), want in zip(library.items(), exact):
        out["cublas" + part], out["err_cublas" + part] = timed(fn), _rel_err(fn(), want)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for (part, fn), want in zip(library.items(), exact):
            out["cublas_tf32" + part] = timed(fn)
            out["err_cublas_tf32" + part] = _rel_err(fn(), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return out


def time_linear_designs(shape, g) -> dict:
    """A linear layer's forward and backward (dX, dW, db) at (m, n, k) on the
    kernel and on cuBLAS: device ms (graph replays), the ms of an eager
    autograd call (``linear`` under ``torch.autograd.grad``: the larger of
    the host's and the device's time, as a layer alone runs) and the host's
    ms alone, the plan's crossover moved out of the way for the design it
    would not pick."""
    m, n, k = shape
    x = torch.randn((m, k), generator=g, device="cuda", requires_grad=True)
    w = torch.randn((n, k), generator=g, device="cuda", requires_grad=True)
    b = torch.randn((n,), generator=g, device="cuda", requires_grad=True)
    dy = torch.randn((m, n), generator=g, device="cuda")
    f = torch.nn.functional.linear
    device = {"warpgroup": lambda: (lin._forward(x, w, b), lin._backward(x, w, dy, True, True),
                                    dy.sum(0)),
              "cublas": lambda: (f(x, w, b), dy @ w, dy.T @ x, dy.sum(0))}
    limits = lin.WG_MIN_ROWS, lin.WG_MIN_WIDTH
    out = {"plan": lin.linear_plan(*shape)}
    try:
        for design, (rows, width) in (("warpgroup", (1, 1)), ("cublas", (2**62, 2**62))):
            lin.WG_MIN_ROWS, lin.WG_MIN_WIDTH = rows, width
            out[design] = graph_ms(device[design], reps=5, iters=5)
            call = lambda: torch.autograd.grad(lin.linear(x, w, b), (x, w, b), dy)  # noqa: E731
            out[design + "_eager"] = cuda_ms(call, iters=20, warmup=5)
            out[design + "_host"] = host_ms(call, iters=20, warmup=5)
    finally:
        lin.WG_MIN_ROWS, lin.WG_MIN_WIDTH = limits
    return out


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(prog="profile_kernels")
    parser.add_argument("--only", choices=["all", "flash", "linear"], default="all")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    if only == "linear":
        linear = {str(shape): time_linear(shape, g) for shape in LINEAR_SHAPES}
        designs = {str(shape): time_linear_designs(shape, g) for shape in LINEAR_CROSSOVER}
        print(json.dumps({"card": card_line(), "linear": linear, "crossover": designs}),
              flush=True)
        return
    has_ids = "segment_ids" in inspect.signature(fa.flash_forward).parameters
    flash = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SHAPES:
            key = f"{str(dtype)[6:]} {shape}"
            flash[key] = {"no_ids": time_flash(shape, g, False, dtype)}
            if has_ids:
                flash[key]["ids"] = time_flash(shape, g, True, dtype)
    crossover = {str(shape): time_designs(shape, g) for shape in CROSSOVER}
    dkv_crossover = {str(shape): time_dkv_designs(shape, g) for shape in DKV_CROSSOVER}
    if only == "flash":
        print(json.dumps({"card": card_line(), "flash": flash, "crossover": crossover,
                          "dkv_crossover": dkv_crossover}), flush=True)
        return
    shifts = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (layout, kind), (view, k) in shift_inputs(g, dtype).items():
            shifts[f"{layout} {str(dtype)[6:]} {kind}"] = time_row_shift(view, k)
    slide, _, centers = patch_input(g)
    patches = time_patches(slide, centers)
    del slide, centers
    print(json.dumps({"card": card_line(), "row_shift": shifts, "extract_patches": patches,
                      "flash": flash, "crossover": crossover, "dkv_crossover": dkv_crossover}),
          flush=True)


if __name__ == "__main__":
    main()
