"""Patch gather from a whole-slide image: the CUDA kernel and its plain versions.

Port of ``mclstexp_tpu/ops/patches.py`` and of the TPU kernels of
``mclstexp_tpu/ops/pallas_patches.py`` (``extract_patches_pallas`` and
``extract_patches_pallas_bytes``, which differ only in how they tile for the
TPU; one kernel serves both here):

    out[i, py, px, :] = slide[y_i - r + py, x_i - r + px, :]    r = P // 2

zero where the source lies outside the slide, and zero in the last row and
column at odd P: the crop box is [c - r, c + r), 2r = P - 1 pixels wide, as
the data layer's host cutter ``extract_patches_np`` fills it (the readers of
both packages cut with it, so every form here computes exactly that, for
every center, inside the slide or far outside it, and every P).

* ``extract_patches_np``: the JAX package's NumPy cutter, copied unchanged;
* ``extract_patches_plain``: the same function as one gather and a zero fill
  in PyTorch, on any device; it serves CPU tensors and is the oracle the
  kernel is held to;
* ``extract_patches``: a CUDA slide launches ``csrc/extract_patches.cu``
  (built at first use) as ``patch_plan`` chooses, counted in
  ``extract_patches.launches``, or raises; a CPU slide runs
  ``extract_patches_plain``.

Offsets are 64-bit: a missing spot's center is -2147483648 (the readers
floor a NaN coordinate) and a Visium full-resolution image holds up to
~2**31 bytes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from mclstexp_tpu_torch.ops.build import load_library

SOURCE = "extract_patches.cu"
ROWS16_THREADS = 256  # gather_rows16: at most, whole output rows per pass
ROWS16_PASSES = 4  # passes over a block's rows
BYTE_THREADS, BYTE_ROWS = 128, 8  # gather_bytes: threads and output rows per block


class PatchPlan(NamedTuple):
    """How ``extract_patches`` launches: the kernel, threads per block,
    output rows per block and the number of blocks (one patch each)."""

    kernel: str  # "gather_rows16" or "gather_bytes"
    threads: int
    rows_per_cta: int
    ctas: int


def patch_plan(n: int, patch: int, channels: int) -> PatchPlan:
    """The launch of ``extract_patches`` for ``n`` patches of ``patch`` x
    ``patch`` pixels of ``channels`` bytes. Where a patch row (patch *
    channels bytes) is whole 16-byte chunks, ``gather_rows16``: a block's
    threads are whole rows of chunk lanes (lanes = the row's chunks, at most
    ``ROWS16_THREADS``), and it owns ``ROWS16_PASSES`` passes of rows.
    Otherwise ``gather_bytes``: ``BYTE_THREADS`` threads and ``BYTE_ROWS``
    rows a block."""
    row_bytes = patch * channels
    if row_bytes % 16:
        return PatchPlan("gather_bytes", BYTE_THREADS, BYTE_ROWS, n * -(-patch // BYTE_ROWS))
    lanes = min(row_bytes // 16, ROWS16_THREADS)
    per_pass = ROWS16_THREADS // lanes
    rows = min(patch, per_pass * ROWS16_PASSES)
    return PatchPlan("gather_rows16", lanes * per_pass, rows, n * -(-patch // rows))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.extract_patches_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def extract_patches_np(
    slide: np.ndarray, centers: np.ndarray, patch_size: int = 224
) -> np.ndarray:
    """Host-side patch cutter for cache building (uint8 in, uint8 out)."""
    r = patch_size // 2
    h, w = slide.shape[:2]
    c = slide.shape[2] if slide.ndim == 3 else 1
    out = np.zeros((len(centers), patch_size, patch_size, c), dtype=slide.dtype)
    for i, (x, y) in enumerate(np.asarray(centers, dtype=np.int64)):
        y0, y1 = y - r, y + r
        x0, x1 = x - r, x + r
        sy0, sy1 = max(y0, 0), min(y1, h)
        sx0, sx1 = max(x0, 0), min(x1, w)
        if sy1 > sy0 and sx1 > sx0:
            out[i, sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = slide[sy0:sy1, sx0:sx1]
    return out


def _check(slide: torch.Tensor, centers: torch.Tensor, patch_size: int) -> None:
    if slide.ndim not in (2, 3):
        raise ValueError(f"extract_patches wants an (H, W, C) or (H, W) slide, got shape "
                         f"{tuple(slide.shape)}")
    if slide.dtype != torch.uint8:
        raise TypeError(f"extract_patches takes a uint8 slide, got {slide.dtype}")
    if centers.ndim != 2 or centers.shape[1] != 2:
        raise ValueError(f"centers must be (N, 2) (x, y), got shape {tuple(centers.shape)}")
    if centers.dtype.is_floating_point or centers.dtype.is_complex or centers.dtype == torch.bool:
        raise TypeError(f"centers must be an integer tensor, got {centers.dtype}")
    if centers.device != slide.device:
        raise ValueError(f"centers on {centers.device} but the slide on {slide.device}")
    if patch_size < 1:
        raise ValueError(f"patch_size must be >= 1, got {patch_size}")


def extract_patches_plain(slide: torch.Tensor, centers: torch.Tensor,
                          patch_size: int = 224) -> torch.Tensor:
    """(N, P, P, C) uint8 patches (C = 1 for an (H, W) slide) as one gather
    over clamped indices and a zero fill, on the slide's device."""
    _check(slide, centers, patch_size)
    img = slide if slide.ndim == 3 else slide[..., None]
    h, w, ch = img.shape
    if h == 0 or w == 0:
        return img.new_zeros((centers.shape[0], patch_size, patch_size, ch))
    r = patch_size // 2
    offs = torch.arange(patch_size, device=img.device)
    c = centers.to(torch.int64)
    rows = c[:, 1:2] - r + offs  # (N, P)
    cols = c[:, 0:1] - r + offs
    inside = offs < 2 * r  # the box is 2r wide: the last row and column stay 0 at odd P
    ok_r = inside & (rows >= 0) & (rows < h)
    ok_c = inside & (cols >= 0) & (cols < w)
    out = img[rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return out.masked_fill_(~(ok_r[:, :, None] & ok_c[:, None, :])[..., None], 0)


def extract_patches(slide: torch.Tensor, centers: torch.Tensor,
                    patch_size: int = 224) -> torch.Tensor:
    """Cut (N, P, P, C) uint8 patches around integer (x, y) pixel centers.

    slide: (H, W, C) or (H, W) uint8, contiguous on the card; centers:
    (N, 2) integers in (x, y) order on the slide's device. A CPU slide runs
    ``extract_patches_plain``; a CUDA slide launches the kernel, one launch
    per call (none for N = 0), counted in ``extract_patches.launches``.
    """
    _check(slide, centers, patch_size)
    if slide.device.type == "cpu":
        return extract_patches_plain(slide, centers, patch_size)
    if slide.device.type != "cuda":
        raise ValueError(f"extract_patches runs on cuda or cpu, got {slide.device}")
    if not slide.is_contiguous():
        raise ValueError(f"the extract_patches kernel needs a contiguous slide; got strides "
                         f"{slide.stride()}")
    h, w = slide.shape[:2]
    c = slide.shape[2] if slide.ndim == 3 else 1
    out = torch.empty((centers.shape[0], patch_size, patch_size, c), dtype=torch.uint8,
                      device=slide.device)
    if out.numel() == 0:
        return out
    xy = centers.to(torch.int64).contiguous()
    plan = patch_plan(centers.shape[0], patch_size, c)
    with torch.cuda.device(slide.device):
        err = _library().extract_patches_launch(
            slide.data_ptr(), xy.data_ptr(), out.data_ptr(), centers.shape[0], h, w, c,
            patch_size, plan.kernel == "gather_rows16", plan.threads, plan.rows_per_cta,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"extract_patches kernel launch failed with CUDA error {err}")
    extract_patches.launches += 1
    return out


extract_patches.launches = 0
