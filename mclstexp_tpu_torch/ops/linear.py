"""fp32 linear maps on the tensor cores: a 3xTF32 warpgroup GEMM for large
shapes, cuBLAS for the rest.

``y = x @ w^T + b`` is the product of every ``DenseT`` (``core/layers.py``)
and of the GraphSAGE blocks' linear (``baselines/layers.py``). The JAX
package leaves it to XLA, and the port left it to cuBLAS. In fp32 with TF32
off, which the port's fp32 models need (one TF32 product keeps ~3 decimal
digits and fails the slide models' checks), cuBLAS runs it as SIMT FFMA
sgemm, near the card's 67 TFLOP/s fp32 ceiling, on no tensor core. So this
module adds a kernel that replaces no TPU kernel: ``csrc/linear_tf32.cu``
runs the product in 3xTF32 on Hopper's ``wgmma`` (each value as its tf32
big part and the tf32 small part of the rest; small * big + big * small +
big * big with fp32 accumulators: fp32 accuracy, as the fp32 flash kernels
have it), where the shape is large enough to fill the card. What bounds it
is the tensor cores' tf32 rate, three products for each multiply-add: at
(M, N, K) = (4096, 3072, 1024) 0.156 ms at 495 TFLOP/s, against ~9 us of
its inputs' and output's bytes.

A tf32 ``wgmma`` reads both operands K-major, so each call first runs a
split pass, ``gemm_tf32_split``, which writes the big and small parts of the
product's operands in the layout it reads, zero-padded to the tiles: rows
to 128, depth to 32. The forward reads x and w as stored; the backward's
dX = dY w needs w^T, and dW = dY^T x needs dY and x transposed (one split
pass for the backward's four copies). Where few output tiles would leave
SMs idle (the weight gradients, whose depth is the slide's rows) the
product is split over slices of its depth whose partial sums a second pass
adds in a fixed order (``split_plan``): no atomics, the same bits on every
run. One C call launches a forward, one a backward; ``forward_plan`` and
``backward_plan`` give each its scratch and slices, once per shape.

``linear_plan(m, n, k)`` picks "warpgroup" or "cublas" from the forward's
shape alone: the kernel at m >= ``WG_MIN_ROWS`` rows with n and k of at
least ``WG_MIN_WIDTH`` (PERF.md section 6, measured on the card). ``linear``
routes a call: to ``linear_fp32`` where x and w are plain fp32 tensors on
CUDA (not DTensors) and the plan picks the kernel; to ``F.linear``
otherwise (bf16, CPU tensors, ``parallel/tp.py``'s DTensor weights, shapes
under the crossover), unchanged. ``linear_fp32`` is a
``torch.autograd.Function``: forward and, in the backward, dX and dW on the
kernel, db = dY summed over rows. On CUDA tensors it launches the kernels
or raises; on CPU tensors it is ``F.linear``, the plain version.
``linear_fp32.wg_launches`` counts the kernel's products (forward, dX, dW:
one each).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from mclstexp_tpu_torch.ops.build import load_library

SOURCE = "linear_tf32.cu"
DEVICE = "cuda"  # the device type whose tensors the kernel takes
ROW_PAD = 128  # the split copies' rows: an output tile is ROW_PAD x ROW_PAD
DEPTH_PAD = 32  # their depth: one stage of the ring
CARD_SMS = 132  # streaming multiprocessors of an H100 SXM: one persistent CTA each
MAX_SPLITS = 8
MIN_SLICE = 4  # k-blocks of DEPTH_PAD in a slice of a split product, at least
STAGE_S = 1.38e-6  # one CTA's time for a k-block of its tile: 0.265 ms / (6 waves x 32) at
                   # (4096, 3072, 1024) (PERF.md section 6)
HBM_BYTES_PER_S = 3.35e12
# Where the kernel takes over from cuBLAS (PERF.md section 6, row 7's table, measured on
# the card): a layer's forward and backward take less device time on the kernel from 384
# rows, but ~0.2 ms more host time (median; 0.08-0.40). A layer alone, eager, is host-bound
# on both: summed over HisToGene's three widths the kernel's eager ms trail cuBLAS's by
# ~50% up to 1,536 rows and are level from 2,048 (3.74 against 3.78 ms), where it saves 42%
# of the device time. A product narrower than 64 (Hist2ST's 1-wide coef output) would waste
# most of a 128-wide tile.
WG_MIN_ROWS = 2048
WG_MIN_WIDTH = 64
MAX_DIM = 2**31 - ROW_PAD  # the launchers' int extents, padded
_PLAIN = (torch.Tensor, nn.Parameter)  # not DTensors, nor any other subclass


@functools.cache
def _entries():
    """(forward, backward) C entry points, their library built at first use;
    each launches the split pass, then its products."""
    lib = load_library(SOURCE)
    fwd, bwd = lib.linear_tf32_fwd_launch, lib.linear_tf32_bwd_launch
    ptr, ld, dim = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # x, ldx, w, ldw, bias, y, scratch, floats, m, n, k, splits, stream
    fwd.argtypes = [ptr, ld, ptr, ld, ptr, ptr, ptr, ld] + [dim] * 4 + [ptr]
    # x, ldx, w, ldw, dy, lddy, dx, dw, scratch, floats, m, n, k, splits_dx, splits_dw, stream
    bwd.argtypes = [ptr, ld, ptr, ld, ptr, ld, ptr, ptr, ptr, ld] + [dim] * 5 + [ptr]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _pad(x: int, to: int) -> int:
    return -(-x // to) * to


def linear_plan(m: int, n: int, k: int) -> str:
    """"warpgroup" or "cublas" for y = x @ w^T with x (m, k), w (n, k).

    The kernel where m >= ``WG_MIN_ROWS`` and n, k >= ``WG_MIN_WIDTH``, and
    every extent is within the launchers' ints; cuBLAS elsewhere (the
    constants say why). Raises ValueError for an empty shape."""
    if min(m, n, k) < 1:
        raise ValueError(f"linear_plan takes m, n, k >= 1, got {(m, n, k)}")
    if max(m, n, k) > MAX_DIM:
        return "cublas"
    if m >= WG_MIN_ROWS and min(n, k) >= WG_MIN_WIDTH:
        return "warpgroup"
    return "cublas"


@functools.lru_cache(maxsize=1024)
def split_plan(rows: int, cols: int, depth: int) -> int:
    """Slices of the depth for a (rows x cols) product over ``depth``: the s in
    1..``MAX_SPLITS`` (each slice at least ``MIN_SLICE`` k-blocks) with the
    least time, in k-blocks of ``STAGE_S``: the waves of persistent CTAs over
    the tiles' slices times the k-blocks of a slice, and for s > 1 the pass
    that reads the s partial sums and writes their sum; ties to the fewer
    slices."""
    tiles = -(-rows // ROW_PAD) * -(-cols // ROW_PAD)
    blocks = _pad(depth, DEPTH_PAD) // DEPTH_PAD
    best, best_cost = 1, None
    for s in range(1, MAX_SPLITS + 1):
        if s > 1 and -(-blocks // s) < MIN_SLICE:
            break
        cost = -(-tiles * s // CARD_SMS) * -(-blocks // s)
        if s > 1:
            cost += (s + 1) * rows * cols * 4 / HBM_BYTES_PER_S / STAGE_S
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _copy(rows: int, depth: int) -> int:
    """Floats of a split copy: both parts, rows padded to a tile, depth to a stage."""
    return 2 * _pad(rows, ROW_PAD) * _pad(depth, DEPTH_PAD)


def _product(rows: int, cols: int, depth: int) -> Tuple[int, int]:
    """(slices, floats of their partial sums) of a (rows x cols) product over depth."""
    s = split_plan(rows, cols, _pad(depth, DEPTH_PAD))
    return s, s * rows * cols if s > 1 else 0


@functools.lru_cache(maxsize=1024)
def forward_plan(m: int, n: int, k: int) -> Tuple[int, int]:
    """(scratch floats, slices) of y = x w^T at (m, n, k): the split copies
    of x and w, then the slices' partial sums where there are more than one
    (the layout ``linear_tf32_fwd_launch`` takes)."""
    splits, partials = _product(m, n, k)
    return _copy(m, k) + _copy(n, k) + partials, splits


@functools.lru_cache(maxsize=1024)
def backward_plan(m: int, n: int, k: int, need_x: bool, need_w: bool
                  ) -> Tuple[int, int, int]:
    """(scratch floats, slices of dX, slices of dW; 0 where not asked) of the
    backward of y = x w^T at (m, n, k): for dX = dY w the copies of dY and
    w^T over n, for dW = dY^T x those of dY^T and x^T over m, then the
    larger of the two products' partial sums (``linear_tf32_bwd_launch``)."""
    floats = partials = splits_x = splits_w = 0
    if need_x:
        splits_x, part = _product(m, k, n)
        floats, partials = floats + _copy(m, n) + _copy(k, n), max(partials, part)
    if need_w:
        splits_w, part = _product(n, k, m)
        floats, partials = floats + _copy(n, m) + _copy(k, m), max(partials, part)
    return floats + partials, splits_x, splits_w


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A 2-D t whose rows the split pass can read: contiguous columns, rows
    at least a row apart (a copy where t's strides are otherwise)."""
    return t if t.stride(-1) == 1 and t.stride(0) >= t.shape[1] else t.contiguous()


def kernel_route(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``linear`` sends ``F.linear(x, w, .)`` to the kernel: x and w
    plain fp32 tensors (neither a DTensor nor another subclass) on CUDA, and
    ``linear_plan`` picks the kernel at (rows of x, out features, in
    features). Shapes ``F.linear`` refuses stay with it."""
    if type(x) not in _PLAIN or type(w) not in _PLAIN:
        return False
    if x.dtype != torch.float32 or w.dtype != torch.float32 or x.device.type != DEVICE:
        return False
    if w.ndim != 2 or x.numel() == 0 or x.shape[-1] != w.shape[1]:
        return False
    return linear_plan(x.numel() // w.shape[1], w.shape[0], w.shape[1]) == "warpgroup"


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, b)``, on the kernel where ``kernel_route`` says so."""
    if kernel_route(x, w):
        return linear_fp32(x, w, b)
    return F.linear(x, w, b)


# ---- the launches ------------------------------------------------------------------------

def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"linear {what} failed with CUDA error {err}")


def _forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """y = x @ w^T + b for 2-D x and w whose rows the split pass reads
    (``_rows``), b contiguous or None: one C call, one product."""
    (m, k), n = x.shape, w.shape[0]
    floats, splits = forward_plan(m, n, k)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _check(_entries()[0](x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
                             None if b is None else b.data_ptr(), y.data_ptr(),
                             scratch.data_ptr(), floats, m, n, k, splits,
                             torch.cuda.current_stream().cuda_stream), "forward")
    linear_fp32.wg_launches += 1
    return y


def _backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, need_x: bool,
              need_w: bool) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dw) = (dy @ w, dy^T @ x), None for what is not asked (one at
    least): one C call, one split pass (dy and w^T for dx; dy^T and x^T for
    dw), then a product each."""
    (m, k), n = x.shape, w.shape[0]
    floats, splits_x, splits_w = backward_plan(m, n, k, need_x, need_w)
    dx = torch.empty((m, k), dtype=torch.float32, device=x.device) if need_x else None
    dw = torch.empty((n, k), dtype=torch.float32, device=x.device) if need_w else None
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _check(_entries()[1](x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
                             dy.data_ptr(), dy.stride(0), None if dx is None else dx.data_ptr(),
                             None if dw is None else dw.data_ptr(), scratch.data_ptr(), floats,
                             m, n, k, splits_x, splits_w,
                             torch.cuda.current_stream().cuda_stream), "backward")
    linear_fp32.wg_launches += need_x + need_w
    return dx, dw


def check_inputs(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> None:
    """Raise unless x (..., k), w (n, k) and b (n,) or None are fp32 on one
    device, with n, k and the rows of x within the launchers' ints."""
    if w.ndim != 2 or x.ndim < 1 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"linear_fp32 wants x (..., k) and w (n, k), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    tensors = (x, w) if b is None else (x, w, b)
    if b is not None and b.shape != (w.shape[0],):
        raise ValueError(f"linear_fp32 wants a bias of ({w.shape[0]},), got {tuple(b.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (
            b is not None and b.dtype != torch.float32):
        raise TypeError(f"linear_fp32 takes float32, got {[t.dtype for t in tensors]}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError(f"linear_fp32's inputs lie on {[str(t.device) for t in tensors]}")
    n, k = w.shape
    if min(x.numel(), n, k) < 1 or max(x.numel() // k, n, k) > MAX_DIM:
        raise ValueError(f"linear_fp32 takes 1 <= rows, n, k <= {MAX_DIM}, got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")


class LinearFP32(torch.autograd.Function):
    """y = x @ w^T + b over a 2-D x on the kernel; the backward's dx and dw
    on the kernel too (each only where asked), db = dy summed over rows."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _forward(x, w, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dy = _rows(dy)
        dx, dw = _backward(x, w, dy, need_x, need_w) if need_x or need_w else (None, None)
        return dx, dw, dy.sum(dim=0) if need_b else None


def linear_fp32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``x @ w^T + b`` for fp32 x (..., k), w (n, k), b (n,) or None: on CUDA
    tensors the kernel (``LinearFP32``; counted in ``wg_launches``) or an
    error, on CPU tensors ``F.linear``."""
    check_inputs(x, w, b)
    if x.device.type != DEVICE:
        return F.linear(x, w, b)
    y = LinearFP32.apply(_rows(x.reshape(-1, x.shape[-1])), _rows(w),
                         None if b is None else b.contiguous())
    return y.reshape(*x.shape[:-1], w.shape[0])


linear_fp32.wg_launches = 0
