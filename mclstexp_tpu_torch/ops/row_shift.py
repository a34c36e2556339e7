"""Per-row pixel shift: the CUDA kernel and its plain PyTorch version.

Port of the TPU kernel ``mclstexp_tpu/ops/pallas_shift.py::row_shift``:

    out[b, y, x, :] = in[b, y, x - k[b, y], :]

zero-filled where the source leaves [0, W), with k clamped to +-W//2 as the
JAX wrapper clamps it. Each shear of the Paeth rotation
(``ops/augment.rotate_batch_paeth``) is one call.

``row_shift`` takes the image either contiguous or as the (1, 2)-transpose
of a contiguous buffer (the column shear), and returns an output with the
same strides, so the column shear needs no transpose copy. A CPU tensor goes
to ``row_shift_plain``; a CUDA tensor launches the kernel in
``csrc/row_shift.cu`` (built at first use) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mclstexp_tpu_torch.ops.build import load_library

SOURCE = "row_shift.cu"
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.row_shift_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
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
    device. Counts each kernel launch in ``row_shift.launches``, and by
    layout in ``row_shift.layout_launches`` ("rows": ``shift_rows``,
    "cols": ``shift_cols``).
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
        layout, col_mode, rows, row_px = "rows", 0, h, w
    elif imgs.transpose(1, 2).is_contiguous():
        layout, col_mode, rows, row_px = "cols", 1, w, h
    else:
        raise ValueError(
            "row_shift kernel needs a contiguous image or the (1, 2)-transpose of one; "
            f"got strides {imgs.stride()}"
        )
    out = torch.empty_like(imgs)  # keeps the input's (possibly transposed) strides
    if imgs.numel() == 0:
        return out
    k = shifts.to(torch.int32).contiguous()
    with torch.cuda.device(imgs.device):
        err = _library().row_shift_launch(
            imgs.data_ptr(), out.data_ptr(), k.data_ptr(), b, rows, row_px, c,
            _ITEMSIZE[imgs.dtype], col_mode, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row_shift kernel launch failed with CUDA error {err}")
    row_shift.launches += 1
    row_shift.layout_launches[layout] += 1
    return out


row_shift.launches = 0
row_shift.layout_launches = {"rows": 0, "cols": 0}
