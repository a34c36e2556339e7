"""Per-row pixel shift: the CUDA kernel and its plain PyTorch version.

Port of the TPU kernel ``mclstexp_tpu/ops/pallas_shift.py::row_shift``:

    out[b, y, x, :] = in[b, y, x - k[b, y], :]

zero-filled where the source leaves [0, W), with k clamped to +-W//2 as the
JAX wrapper clamps it. Each shear of the Paeth rotation
(``ops/augment.rotate_batch_paeth``) is one call.

``row_shift`` takes the image either contiguous or as the (1, 2)-transpose
of a contiguous buffer (the column shear), and returns an output with the
same strides, so the column shear needs no transpose copy. A CPU tensor goes
to ``row_shift_plain``; a CUDA tensor launches a kernel of
``csrc/row_shift.cu`` (built at first use), as ``shift_plan`` chooses it,
or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mclstexp_tpu_torch.ops.build import load_library

SOURCE = "row_shift.cu"
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# The kernels of csrc/row_shift.cu, indexed by the id its C entry takes.
KERNELS = ("shift_rows", "shift_rows16", "shift_cols", "shift_cols_band")
ROW_THREADS = 256  # shift_rows, shift_cols: one block per memory row
ROWS16_THREADS = 256  # shift_rows16: at most, one block per memory row
BAND_ROW_BYTES = 192  # the band path's widest band row
BAND_SMEM_MAX = 48 * 1024  # the band's column in dynamic shared memory, without an opt-in
BAND_THREADS = 256  # at most, whole band rows per pass


class ShiftPlan(NamedTuple):
    """How ``row_shift`` launches: the kernel, the band width in pixels (0
    off the band path), threads per block, dynamic shared memory per block
    and the number of blocks."""

    kernel: str  # one of KERNELS
    band_px: int
    threads: int
    smem_bytes: int
    blocks: int


def shift_plan(batch: int, rows: int, row_px: int, channels: int, itemsize: int,
               col_mode: bool, aligned: bool = True) -> ShiftPlan:
    """The launch of ``row_shift`` over ``batch`` images of ``rows`` memory
    rows of ``row_px`` pixels of ``channels`` elements of ``itemsize`` bytes.

    The 16-byte kernels need 16-byte ``aligned`` buffers and memory rows of
    whole 16-byte chunks; otherwise one block of ``ROW_THREADS`` per memory
    row, one element per thread per access (``shift_rows``, ``shift_cols``).
    Row layout: ``shift_rows16``, one block per memory row, a thread per
    chunk (whole warps, at most ``ROWS16_THREADS``). Column layout:
    ``shift_cols_band``, one block per (image, band of ``band_px`` pixels)
    where some band of whole chunks has its column (rows x band row) within
    ``BAND_SMEM_MAX``; the band is the widest such band of at most
    ``BAND_ROW_BYTES`` a row (and of at most ``row_px`` pixels), and the
    threads are whole band rows, at most ``BAND_THREADS``."""
    px_bytes = channels * itemsize
    row_bytes = row_px * px_bytes
    per_row = ShiftPlan("shift_cols" if col_mode else "shift_rows", 0, ROW_THREADS, 0,
                        batch * rows)
    if not aligned or row_bytes % 16:
        return per_row
    if not col_mode:
        warps = -(-(row_bytes // 16) // 32)
        return ShiftPlan("shift_rows16", 0, min(32 * warps, ROWS16_THREADS), 0, batch * rows)
    unit = 16 // math.gcd(16, px_bytes)  # the fewest pixels of whole 16-byte chunks
    widest = min(BAND_ROW_BYTES // px_bytes, row_px, BAND_SMEM_MAX // (max(rows, 1) * px_bytes))
    band = widest // unit * unit
    if band < unit:
        return per_row
    lanes = band * px_bytes // 16
    return ShiftPlan("shift_cols_band", band, lanes * max(1, BAND_THREADS // lanes),
                     rows * band * px_bytes, batch * -(-row_px // band))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.row_shift_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(imgs: torch.Tensor, shifts: torch.Tensor) -> None:
    if imgs.ndim != 4:
        raise ValueError(f"row_shift wants (B, H, W, C) images, got shape {tuple(imgs.shape)}")
    if tuple(shifts.shape) != tuple(imgs.shape[:2]):
        raise ValueError(
            f"shifts must be (B, H) = {tuple(imgs.shape[:2])}, got {tuple(shifts.shape)}"
        )
    if shifts.dtype.is_floating_point or shifts.dtype.is_complex or shifts.dtype == torch.bool:
        raise TypeError(f"shifts must be an integer tensor, got {shifts.dtype}")
    if shifts.device != imgs.device:
        raise ValueError(f"shifts on {shifts.device} but images on {imgs.device}")


def row_shift_plain(imgs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The same function as one gather plus a zero fill (any device); like
    the kernel, the output keeps the input's strides."""
    _check(imgs, shifts)
    b, h, w, c = imgs.shape
    k = shifts.long().clamp(-(w // 2), w // 2)
    src = torch.arange(w, device=imgs.device) - k[..., None]  # (B, H, W)
    invalid = (src < 0) | (src >= w)
    idx = src.clamp(0, w - 1)[..., None].expand(b, h, w, c)
    out = torch.gather(imgs, 2, idx, out=torch.empty_like(imgs))
    return out.masked_fill_(invalid[..., None], 0)


def row_shift(imgs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Shift every row of every image by its own integer pixel offset.

    imgs: (B, H, W, C) float32 or bfloat16, contiguous or the (1, 2)-
    transpose of a contiguous tensor. shifts: (B, H) integers on the same
    device. Counts each kernel launch in ``row_shift.launches`` and, by the
    kernel ``shift_plan`` chose (which names the layout), in
    ``row_shift.kernel_launches``.
    """
    _check(imgs, shifts)
    if imgs.device.type == "cpu":
        return row_shift_plain(imgs, shifts)
    if imgs.device.type != "cuda":
        raise ValueError(f"row_shift runs on cuda or cpu, got {imgs.device}")
    if imgs.dtype not in _ITEMSIZE:
        raise TypeError(f"row_shift kernel takes float32 or bfloat16, got {imgs.dtype}")
    b, h, w, c = imgs.shape
    if imgs.is_contiguous():
        col_mode, rows, row_px = 0, h, w
    elif imgs.transpose(1, 2).is_contiguous():
        col_mode, rows, row_px = 1, w, h
    else:
        raise ValueError(
            "row_shift kernel needs a contiguous image or the (1, 2)-transpose of one; "
            f"got strides {imgs.stride()}"
        )
    out = torch.empty_like(imgs)  # keeps the input's (possibly transposed) strides
    if imgs.numel() == 0:
        return out
    k = shifts.to(torch.int32).contiguous()
    itemsize = _ITEMSIZE[imgs.dtype]
    plan = shift_plan(b, rows, row_px, c, itemsize, col_mode,
                      aligned=imgs.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(imgs.device):
        err = _library().row_shift_launch(
            imgs.data_ptr(), out.data_ptr(), k.data_ptr(), b, rows, row_px, c, itemsize,
            KERNELS.index(plan.kernel), plan.band_px, plan.threads,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row_shift kernel launch failed with CUDA error {err}")
    row_shift.launches += 1
    row_shift.kernel_launches[plan.kernel] += 1
    return out


row_shift.launches = 0
row_shift.kernel_launches = dict.fromkeys(KERNELS, 0)
