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
  launches at it (``time_flash``). ``--only flash`` times these alone.

Each data-movement case is checked bit-equal to the plain version (the
flash kernels are checked by ``chip_smoke.py`` and the card tests) and
timed two ways: ``ms``, CUDA events over eager launches (the wrapper's host
cost included when it exceeds the kernel's time), and ``graph_ms``,
CUDA-graph replays (device time alone). Prints one JSON object with the
card's name and power limit. ``chip_smoke.py`` takes its kernel timings
from here; to compare a parent commit in one chip call, unpack it into
``build/parent``, copy this file into its package and run parent, change,
change, parent.
"""

from __future__ import annotations

import inspect
import json
import subprocess

import numpy as np
import torch

from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops import flash_attention as fa
from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_plain
from mclstexp_tpu_torch.ops.row_shift import row_shift, row_shift_plain

FLAGSHIP = (128, 224, 224, 3)  # the Paeth shears' images at the her2st widths
I32_MIN = -2**31
VISIUM_SIDE = 20_000  # a Visium full-resolution image.tif is about 20,000-25,000 px a side
PATCH = 224
FLASH_SHAPES = ((1, 8, 32, 64), (1, 8, 66, 64), (1, 8, 128, 64), (1, 8, 300, 64),
                (1, 16, 768, 64), (1, 16, 4096, 64))
FLASH_PADDED = 63  # rows of the padded tail in the segment-id case


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


def time_flash(shape, g, segments: bool, dtype=torch.float32) -> dict:
    """ms per call of the flash forward (without and with residuals), dK/dV
    and dQ at ``shape`` in ``dtype`` on the views of one qkv buffer, with
    segment ids (the last ``FLASH_PADDED`` rows padded) or without."""
    b, h, n, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, n, d), generator=g, device="cuda").to(dtype)
    scale = d**-0.5
    ids = ((torch.arange(n, device="cuda") < n - FLASH_PADDED).to(torch.int32)[None]
           .expand(b, n).contiguous(),) if segments else ()
    out, l, m = fa.flash_forward(q, k, v, scale, True, *ids)
    di = (out.float() * do.float()).sum(-1).contiguous()
    timed = (lambda fn: cuda_ms(fn, iters=10, warmup=2)) if n >= 4096 else graph_ms
    return {"fwd": timed(lambda: fa.flash_forward(q, k, v, scale, False, *ids)),
            "fwd_res": timed(lambda: fa.flash_forward(q, k, v, scale, True, *ids)),
            "bwd_dkv": timed(lambda: fa.flash_bwd_dkv(q, k, v, do, l, m, di, scale, *ids)),
            "bwd_dq": timed(lambda: fa.flash_bwd_dq(q, k, v, do, l, m, di, scale, *ids))}


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(prog="profile_kernels")
    parser.add_argument("--only", choices=["all", "flash"], default="all")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    has_ids = "segment_ids" in inspect.signature(fa.flash_forward).parameters
    flash = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SHAPES:
            key = f"{str(dtype)[6:]} {shape}"
            flash[key] = {"no_ids": time_flash(shape, g, False, dtype)}
            if has_ids:
                flash[key]["ids"] = time_flash(shape, g, True, dtype)
    if only == "flash":
        print(json.dumps({"card": card_line(), "flash": flash}), flush=True)
        return
    shifts = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (layout, kind), (view, k) in shift_inputs(g, dtype).items():
            shifts[f"{layout} {str(dtype)[6:]} {kind}"] = time_row_shift(view, k)
    slide, _, centers = patch_input(g)
    patches = time_patches(slide, centers)
    del slide, centers
    print(json.dumps({"card": card_line(), "row_shift": shifts, "extract_patches": patches,
                      "flash": flash}), flush=True)


if __name__ == "__main__":
    main()
