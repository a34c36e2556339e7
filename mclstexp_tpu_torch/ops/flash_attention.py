"""Softmax attention: the CUDA flash-attention kernels and their plain versions.

Port of the TPU kernels that ``mclstexp_tpu/core/layers.py:201-219`` reaches
for ``attn_backend="flash"`` (``jax.experimental.pallas.ops.tpu.
flash_attention``, jax 0.9.0), forward and backward:

    out = softmax(q @ k^T * scale) @ v      q, k, v, out: (b, h, n, d)

* forward, ``csrc/flash_attention.cu`` (``_flash_attention_impl``, call
  :758): fp32 online softmax; with residuals it also writes each row's max
  ``m`` and sum ``l`` (the TPU kernel's ``save_residuals``), (b, h, n) fp32.
  Each block of 32 queries is one thread-block cluster of ``split`` CTAs,
  which share the walk over the key tiles and merge their partial (m, l,
  out) over distributed shared memory in a fixed order;
* dK/dV, ``csrc/flash_attention_bwd.cu`` (``_flash_attention_bwd_dkv``,
  call :1121) and dQ, same file (``_flash_attention_bwd_dq``, call :1456):
  from q, k, v, dout, l, m and ``di = rowsum(out * dout)`` they recompute
  ``p = exp(s - m) / l`` and give ``dv = p^T dout``, ``dk = ds^T q`` and
  ``dq = ds k`` with ``ds = p * (dout v^T - di) * scale``. Each block of 32
  keys (queries) is one thread-block cluster of ``split`` CTAs, which share
  the walk over the query (key) tiles and add their partial sums over
  distributed shared memory in a fixed order.

All three are deterministic (no atomics) and share one plan,
``cluster_plan``, which chooses ``split``. Their products run on the tensor
cores in the 3xTF32 split, which keeps fp32 accuracy (within 2e-5 of the
plain versions; one plain TF32 product would not be).

bfloat16 (``ModelConfig.dtype="bfloat16"``: the JAX modules hand the
library kernels q, k, v in the compute dtype): each kernel has a bf16
counterpart (``csrc/flash_attention_bf16.cu``,
``csrc/flash_attention_bwd_bf16.cu``) that does the library's casts at the
library's places:
p to bf16 before ``p @ v``, p^T before ``p^T @ dout``, ds before ``ds @ k``
and ``ds^T @ q``; l, m and ``di`` stay fp32, the outputs are bf16. The
plain versions do the same casts (exact bf16 products, fp32 sums, one
rounding of each output) and are the bf16 kernels' oracle. A bf16 CUDA
tensor launches the bf16 kernel (``bf16_launches``, ``bf16_segment_launches``
on each wrapper) or raises; nothing is cast to fp32 to reach the fp32 one.
The bf16 forward and dK/dV are Hopper warpgroup kernels (``wgmma`` on 64-row
tiles, one CTA per block, K/V or Q/dout through a two-stage TMA ring;
``bf16_plan``); their C launchers take the TMA variant where every input
view allows it and the one that stages by plain loads elsewhere
(``tma_ok`` says which, for reports). The bf16 dQ keeps the fp32 kernels'
32-row ``cluster_plan`` and mma.sync m16n8k16.

Segment ids (the TPU kernels' ``SegmentIds(q=m, kv=m)``, which
``core/layers.py:207-212`` builds from a slide's padding mask): an int32
(b, n) tensor, one for both sides; query i and key j interact only where
``seg[b, i] == seg[b, j]``. Every row then sees at least itself, so no row's
softmax is empty. All three kernels take them (null for none), and each
counts such launches in ``segment_launches`` beside ``launches``.

``attention_plain`` is the spot tower's fused-matmul path ("xla"): it serves
CPU tensors without a gradient and, on the CPU, the key mask (what the JAX
module computes off a TPU). ``flash_forward_plain``, ``flash_bwd_dkv_plain``
and ``flash_bwd_dq_plain`` compute exactly what the three kernels compute,
with the same decomposition and the same segment ids: they serve CPU
tensors and are the oracles the kernels are held to. Each wrapper launches
its kernel (built at first use) for a CUDA tensor, counted in its
``launches``, or raises; it never runs a plain version on the card.

``flash_attention`` is differentiable: where an input needs a gradient it
runs ``FlashAttention``, a ``torch.autograd.Function`` whose forward keeps
the residuals and whose backward launches dK/dV and dQ (on the CPU, the same
Function over the plain versions). It is once-differentiable, as the TPU
kernel is (higher-order AD raises there too). The Function takes q, k and v
as three tensors, so autograd adds the three view gradients into the qkv
projection's buffer itself.

The kernels' shape rule (the TPU kernel's ``n % 128 == 0 and d >= 64`` is a
TPU tiling limit and does not apply): float32 or bfloat16 q, k, v of one
type and one shape (b, h, n, d) on one card, any n >= 1 with ceil(n / 32) <=
65535 and b * h * split < 2**31, and 1 <= d <= 128;
each tensor's last dimension contiguous, any strides otherwise, so the (b,
n, 3, h, d) qkv buffer's views are read in place. Outputs are (b, n, h, d)
buffers returned as their (b, h, n, d) views; segment ids a contiguous
int32 (b, n) on the same card. A CUDA call outside the rule raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from mclstexp_tpu_torch.ops.build import load_library

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
BF16_SOURCE = "flash_attention_bf16.cu"
BF16_BWD_SOURCE = "flash_attention_bwd_bf16.cu"
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' element types
MAX_HEAD_DIM = 128
ROWS = 32  # rows of every tile, owned or walked: the grid's second dimension is ceil(n / 32)
BF16_ROWS = 64  # the bf16 forward's and dK/dV's tiles: one warpgroup's wgmma rows
BF16_STAGES = 2  # depth of their ring of walked tiles (csrc/flash_wgmma.cuh kStages)
MAX_SPLIT = 8  # CTAs of a cluster: the portable cluster size
CARD_SMS = 132  # streaming multiprocessors of an H100 SXM


# Every entry point ends in: the segment ids (null for none); strides; b, h,
# n, d, then the plan's rows and split; scale, stream.
_TAIL = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _fwd_entry(dtype: torch.dtype):
    """The forward's C entry point for ``dtype`` (its library built at first use)."""
    bf16 = dtype == torch.bfloat16
    fn = getattr(load_library(BF16_SOURCE if bf16 else SOURCE),
                 "flash_attention_fwd_bf16_launch" if bf16 else "flash_attention_fwd_launch")
    # q, k, v, out, l, m (l and m null without residuals)
    fn.argtypes = [ctypes.c_void_p] * 6 + _TAIL
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entries(dtype: torch.dtype):
    """(dK/dV, dQ) C entry points for ``dtype``."""
    bf16 = dtype == torch.bfloat16
    lib = load_library(BF16_BWD_SOURCE if bf16 else BWD_SOURCE)
    suffix = "_bf16_launch" if bf16 else "_launch"
    dkv = getattr(lib, "flash_attention_bwd_dkv" + suffix)
    dq = getattr(lib, "flash_attention_bwd_dq" + suffix)
    head = [ctypes.c_void_p] * 7  # q, k, v, dout, l, m, di
    dkv.argtypes = head + [ctypes.c_void_p] * 2 + _TAIL
    dq.argtypes = head + [ctypes.c_void_p] + _TAIL
    dkv.restype = dq.restype = ctypes.c_int
    return dkv, dq


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, h, n, d) -> (b, h, n, d): fp32 logits and softmax, masked keys
    (``mask``: (b, n) or (n,) key validity) filled with -1e30."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        b, n = q.shape[0], k.shape[2]
        key_mask = torch.broadcast_to(mask, (b, n))[:, None, None, :]
        logits = torch.where(key_mask, logits, torch.full_like(logits, -1e30))
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def same_segment(segment_ids: torch.Tensor) -> torch.Tensor:
    """(b, n) ids -> (b, 1, n, n) bool: query i may see key j."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def _scores(q, k, scale, segment_ids):
    """s = q @ k^T * scale in fp32 (exact bf16 products, fp32 sums), -inf
    where the segment ids differ."""
    s = torch.matmul(widen(q), widen(k).transpose(-1, -2)) * scale
    if segment_ids is None:
        return s
    return s.masked_fill(~same_segment(segment_ids), -torch.inf)


def widen(x: torch.Tensor) -> torch.Tensor:
    """A bf16 x in fp32 (exactly); fp32 and float64 as they are."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to bf16 before a product of bf16 inputs, as the library
    casts p, p^T and ds (``p.astype(v.dtype)``); the product then sums in
    fp32. The identity for wider inputs."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward with its residuals: (out, l, m), l and m (b, h, n) fp32,
    ``out = (exp(s - m) / l) @ v`` for ``s = q @ k^T * scale`` over the keys
    of each query's segment. In bf16, the library's casts: p = exp(s - m)
    rounded to bf16 before ``p @ v`` (fp32 sums), divided by l and rounded
    to bf16 once."""
    s = _scores(q, k, scale, segment_ids)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if q.dtype != torch.bfloat16:
        return torch.matmul(p * (1.0 / l)[..., None], v), l, m
    out = torch.matmul(_operand(p, q.dtype), v.float()) / l[..., None]
    return out.to(q.dtype), l, m


def _probs_and_ds(q, k, v, do, l, m, di, scale, segment_ids):
    """The backward kernels' common part, in fp32: p = exp(s - m) / l (0
    across segments) and ds = p * (do @ v^T - di) * scale, both (b, h, n,
    n)."""
    s = _scores(q, k, scale, segment_ids)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    dp = torch.matmul(widen(do), widen(v).transpose(-1, -2))
    return p, (dp - di[..., None]) * p * scale


def flash_bwd_dkv_plain(q, k, v, do, l, m, di, scale: float,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) = (ds^T @ q, p^T @ do): what the dK/dV kernel computes; in
    bf16 ds^T and p^T rounded to bf16 before their products (fp32 sums), dk
    and dv rounded once."""
    p, ds = _probs_and_ds(q, k, v, do, l, m, di, scale, segment_ids)
    dt = q.dtype
    return (torch.matmul(_operand(ds, dt).transpose(-1, -2), widen(q)).to(dt),
            torch.matmul(_operand(p, dt).transpose(-1, -2), widen(do)).to(dt))


def flash_bwd_dq_plain(q, k, v, do, l, m, di, scale: float,
                       segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq = ds @ k: what the dQ kernel computes (in bf16, ds rounded to bf16
    first, dq once)."""
    _, ds = _probs_and_ds(q, k, v, do, l, m, di, scale, segment_ids)
    return torch.matmul(_operand(ds, q.dtype), widen(k)).to(q.dtype)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless (q, k, v) fit the kernel's shape rule (module docstring)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention wants q, k, v of one (b, h, n, d) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16 (one type), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, h, n, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes 1 <= d <= {MAX_HEAD_DIM}, got d={d}")
    if b * h == 0 or n == 0:
        raise ValueError(f"flash_attention kernel needs a non-empty input, got {tuple(q.shape)}")
    if -(-n // ROWS) > 65535:
        raise ValueError(f"flash_attention kernel takes n <= {65535 * ROWS}, got {n}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs the last dimension contiguous; got "
                         f"strides {q.stride()}, {k.stride()}, {v.stride()}")


def _check_segments(q: torch.Tensor, segment_ids: Optional[torch.Tensor]) -> None:
    """Raise unless ``segment_ids`` is None or a contiguous int32 (b, n) on
    q's device."""
    if segment_ids is None:
        return
    b, _, n, _ = q.shape
    if (segment_ids.shape != (b, n) or segment_ids.dtype != torch.int32
            or not segment_ids.is_contiguous() or segment_ids.device != q.device):
        raise ValueError(f"segment ids must be a contiguous int32 ({b}, {n}) on {q.device}, "
                         f"got {segment_ids.dtype} {tuple(segment_ids.shape)} on "
                         f"{segment_ids.device}")


def _count(wrapper, q: torch.Tensor, segment_ids: Optional[torch.Tensor]) -> None:
    """One launch of the fp32 kernel (``launches``, ``segment_launches``) or
    of the bf16 one (``bf16_launches``, ``bf16_segment_launches``)."""
    prefix = "bf16_" if q.dtype == torch.bfloat16 else ""
    setattr(wrapper, prefix + "launches", getattr(wrapper, prefix + "launches") + 1)
    if segment_ids is not None:
        name = prefix + "segment_launches"
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _on_cuda(q: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for any other."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, got {q.device}")
    return q.device.type == "cuda"


def _bhnd_like(q: torch.Tensor) -> torch.Tensor:
    """An output for q's shape and type: the (b, h, n, d) view of a (b, n, h,
    d) buffer."""
    b, h, n, d = q.shape
    return torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  residuals: bool = False, segment_ids: Optional[torch.Tensor] = None):
    """Launch the forward kernel on CUDA tensors: ``out``, or ``(out, l, m)``
    with ``residuals``. Counted in ``flash_attention.launches`` (and
    ``.segment_launches`` with segment ids)."""
    check_kernel_inputs(q, k, v)
    _check_segments(q, segment_ids)
    b, h, n, d = q.shape
    out = _bhnd_like(q)
    l = m = None
    if residuals:
        l, m = (torch.empty((b, h, n), dtype=torch.float32, device=q.device) for _ in range(2))
    _launch(_fwd_entry(q.dtype), "flash_attention",
            (q, k, v, out, l, m), segment_ids, (q, k, v, out), scale, warpgroup=True)
    _count(flash_attention, q, segment_ids)
    return (out, l, m) if residuals else out


def cluster_plan(b: int, h: int, n: int, d: int) -> Tuple[int, int, int]:
    """(rows, split, ctas) of the flash kernels at (b, h, n, d).

    Each kernel owns blocks of ``rows`` = 32 queries (forward, dQ) or keys
    (dK/dV), b * h * ceil(n / 32) of them, and splits the walk over the
    other side's ceil(n / 32) tiles among ``split`` CTAs of one cluster: the
    smallest split in 1..min(8, tiles) that puts at least 132 CTAs (one per
    SM) on the card, else the cap. ``ctas`` = blocks * split. Raises
    ValueError outside the kernels' limits."""
    if min(b, h, n) < 1 or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take b, h, n >= 1 and 1 <= d <= {MAX_HEAD_DIM}, "
                         f"got {(b, h, n, d)}")
    tiles = -(-n // ROWS)
    if tiles > 65535:
        raise ValueError(f"the flash kernels take n <= {65535 * ROWS}, got {n}")
    blocks = b * h * tiles
    cap = min(MAX_SPLIT, tiles)
    split = next((s for s in range(1, cap + 1) if blocks * s >= CARD_SMS), cap)
    if b * h * split >= 2**31:
        raise ValueError(f"the flash kernels take b * h * split < 2**31, got {b} * {h} * "
                         f"{split}")
    return ROWS, split, blocks * split


def bf16_plan(b: int, h: int, n: int, d: int) -> Tuple[int, int, int, int]:
    """(rows, split, ctas, stages) of the bf16 forward and dK/dV kernels at
    (b, h, n, d).

    Each owns blocks of ``rows`` = 64 queries (forward) or keys (dK/dV), one
    warpgroup's ``wgmma`` tile, b * h * ceil(n / 64) of them, one CTA each
    (``split`` = 1, ``ctas`` = the blocks): a CTA walks all of the other
    side's ceil(n / 64) tiles, which come through a ring of ``stages`` = 2.
    (A cluster split of the walk lost to split 1 on the card at every shape
    the port launches; PERF.md PR 11.) Raises ValueError outside the
    kernels' limits."""
    if min(b, h, n) < 1 or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the bf16 flash kernels take b, h, n >= 1 and 1 <= d <= "
                         f"{MAX_HEAD_DIM}, got {(b, h, n, d)}")
    tiles = -(-n // BF16_ROWS)
    if tiles > 65535:
        raise ValueError(f"the bf16 flash kernels take n <= {65535 * BF16_ROWS}, got {n}")
    if b * h >= 2**31:
        raise ValueError(f"the bf16 flash kernels take b * h < 2**31, got {b} * {h}")
    return BF16_ROWS, 1, b * h * tiles, BF16_STAGES


def tma_ok(*tensors: torch.Tensor) -> bool:
    """Whether the warpgroup kernels' launchers copy these (b, h, n, d) bf16
    inputs by TMA, as their ``wg::tma_ok`` decides (``csrc/flash_wgmma.cuh``):
    d % 8 == 0, every base 16-byte aligned and the stride of every dimension
    longer than 1 a multiple of 8 elements (16 bytes). Otherwise they take
    the variant that stages the same tiles by 2-byte loads. For reports and
    tests; nothing passes it to a kernel."""
    b, h, n, d = tensors[0].shape
    return d % 8 == 0 and all(
        t.data_ptr() % 16 == 0
        and all(s % 8 == 0 for s, e in zip(t.stride()[:3], (b, h, n)) if e > 1)
        for t in tensors)


def _launch(fn, what: str, pointers, segment_ids, strided, scale: float,
            warpgroup: bool = False) -> None:
    """``fn(*pointers, segment_ids, strides, b, h, n, d, rows, split, scale,
    stream)`` for q = ``strided[0]`` under ``cluster_plan``, or under
    ``bf16_plan`` for a bf16 launch of a ``warpgroup`` kernel (the forward,
    dK/dV). Raises on a CUDA error."""
    q = strided[0]
    strides = (ctypes.c_longlong * (3 * len(strided)))(
        *(s for t in strided for s in t.stride()[:3]))
    plan = bf16_plan if warpgroup and q.dtype == torch.bfloat16 else cluster_plan
    rows, split = plan(*q.shape)[:2]
    with torch.cuda.device(q.device):
        err = fn(*(None if t is None else t.data_ptr() for t in (*pointers, segment_ids)),
                 strides, *q.shape,
                 rows, split, float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _check_bwd_inputs(q, k, v, do, l, m, di) -> None:
    check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"dout must be {q.dtype} {tuple(q.shape)} with the last dimension "
                         f"contiguous, got {do.dtype} {tuple(do.shape)} {do.stride()}")
    for name, t in (("l", l), ("m", m), ("di", di)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape[:3])}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if any(t.device != q.device for t in (do, l, m, di)):
        raise ValueError("the backward's inputs lie on more than one device")


def flash_bwd_dkv(q, k, v, do, l, m, di, scale: float,
                  segment_ids: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv): ``flash_bwd_dkv_plain`` for CPU tensors; the dK/dV kernel,
    counted in ``flash_bwd_dkv.launches`` (and ``.segment_launches``), for
    CUDA ones."""
    if not _on_cuda(q, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, l, m, di, scale, segment_ids)
    _check_bwd_inputs(q, k, v, do, l, m, di)
    _check_segments(q, segment_ids)
    dk, dv = _bhnd_like(q), _bhnd_like(q)
    _launch(_bwd_entries(q.dtype)[0], "flash_attention backward",
            (q, k, v, do, l, m, di, dk, dv), segment_ids, (q, k, v, do, dk, dv), scale,
            warpgroup=True)
    _count(flash_bwd_dkv, q, segment_ids)
    return dk, dv


def flash_bwd_dq(q, k, v, do, l, m, di, scale: float,
                 segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq: ``flash_bwd_dq_plain`` for CPU tensors; the dQ kernel, counted in
    ``flash_bwd_dq.launches`` (and ``.segment_launches``), for CUDA ones."""
    if not _on_cuda(q, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, l, m, di, scale, segment_ids)
    _check_bwd_inputs(q, k, v, do, l, m, di)
    _check_segments(q, segment_ids)
    dq = _bhnd_like(q)
    _launch(_bwd_entries(q.dtype)[1], "flash_attention backward",
            (q, k, v, do, l, m, di, dq), segment_ids, (q, k, v, do, dq), scale)
    _count(flash_bwd_dq, q, segment_ids)
    return dq


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v with the flash backward: the forward keeps
    (out, l, m), the backward computes ``di = rowsum(out * dout)`` (outside
    the kernels, as the JAX library does) and runs dK/dV and dQ, all with
    the same segment ids (None for none; they take no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, segment_ids: Optional[torch.Tensor] = None):
        if _on_cuda(q, "flash_attention"):
            out, l, m = flash_forward(q, k, v, scale, residuals=True, segment_ids=segment_ids)
        else:
            out, l, m = flash_forward_plain(q, k, v, scale, segment_ids)
        ctx.save_for_backward(q, k, v, out, l, m)
        ctx.scale, ctx.segment_ids = scale, segment_ids
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, l, m = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
            do = do.contiguous()
        di = (widen(out) * widen(do)).sum(dim=-1).contiguous()  # fp32 for bf16, as the library
        dk, dv = flash_bwd_dkv(q, k, v, do, l, m, di, ctx.scale, ctx.segment_ids)
        dq = flash_bwd_dq(q, k, v, do, l, m, di, ctx.scale, ctx.segment_ids)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over (b, h, n, d) tensors; ``mask``: (b, n)
    or (n,) validity of a padded sequence.

    On a CUDA tensor the mask becomes segment ids (``int32(mask)``, as
    ``core/layers.py:211-212`` builds them): real rows see real keys only,
    padded rows padded keys only. Where an input needs a gradient,
    ``FlashAttention`` (the kernels); otherwise the forward kernel without
    residuals. On a CPU tensor a mask keeps the key mask of
    ``attention_plain``, what the JAX module computes off a TPU (the two
    agree on real rows); without a mask, ``FlashAttention`` over the plain
    versions where a gradient is wanted, else ``attention_plain``.
    """
    on_cuda = _on_cuda(q, "flash_attention")
    if mask is not None and not on_cuda:
        return attention_plain(q, k, v, scale, mask)
    seg = None
    if mask is not None:
        b, n = q.shape[0], q.shape[2]
        seg = torch.broadcast_to(mask, (b, n)).to(torch.int32).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale, seg)
    if not on_cuda:
        return attention_plain(q, k, v, scale)
    return flash_forward(q, k, v, scale, segment_ids=seg)


for _wrapper in (flash_attention, flash_bwd_dkv, flash_bwd_dq):
    _wrapper.launches = _wrapper.segment_launches = 0
    _wrapper.bf16_launches = _wrapper.bf16_segment_launches = 0
del _wrapper
