"""Softmax attention: the CUDA flash-attention forward and its plain version.

Port of the TPU kernel that ``mclstexp_tpu/core/layers.py:201-219`` calls for
``attn_backend="flash"`` (``jax.experimental.pallas.ops.tpu.flash_attention``):

    out = softmax(q @ k^T * scale) @ v      q, k, v, out: (b, h, n, d)

with the softmax in fp32. ``attention_plain`` is the spot tower's
fused-matmul path ("xla"); it serves CPU tensors, the key mask, and is the
oracle the kernel is held to. ``flash_attention`` launches the kernel in
``csrc/flash_attention.cu`` (built at first use) for a CUDA tensor, or
raises; it never runs the plain version on the card.

The kernel's shape rule (the TPU kernel's ``n % 128 == 0 and d >= 64`` is a
TPU tiling limit and does not apply): float32 q, k, v of one shape
(b, h, n, d) on one card, any n >= 1 with ceil(n / 32) <= 65535, and
1 <= d <= 128; each tensor's last dimension contiguous, any strides
otherwise, so the (b, n, 3, h, d) qkv buffer's views are read in place. The
output is a (b, n, h, d) buffer returned as its (b, h, n, d) view. A CUDA
call outside the rule raises, and so do two cases the kernel does not cover
yet: a key mask (the TPU kernel's segment ids) and inputs that need a
gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mclstexp_tpu_torch.ops.build import load_library

SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 128
BLOCK_Q = 32  # query rows per CTA: the grid's second dimension is ceil(n / 32)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.flash_attention_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


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


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless (q, k, v) fit the kernel's shape rule (module docstring)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention wants q, k, v of one (b, h, n, d) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"flash_attention kernel takes float32, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, n, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes 1 <= d <= {MAX_HEAD_DIM}, got d={d}")
    if b * h == 0 or n == 0:
        raise ValueError(f"flash_attention kernel needs a non-empty input, got {tuple(q.shape)}")
    if -(-n // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention kernel takes n <= {65535 * BLOCK_Q}, got {n}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs the last dimension contiguous; got "
                         f"strides {q.stride()}, {k.stride()}, {v.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over (b, h, n, d) tensors.

    A CPU tensor goes to ``attention_plain`` (mask included); a CUDA tensor
    launches the kernel, counted in ``flash_attention.launches``, or raises.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    if mask is not None:
        raise NotImplementedError(
            "flash_attention with a key mask (the TPU kernel's segment ids) is not ported "
            "yet (ROADMAP.md Queue 1 item 11, with the baselines that need it); use "
            "attn_backend='xla'")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernels yet (ROADMAP.md Queue 1 item 1, "
            "flash training); run it under torch.no_grad() or use attn_backend='xla'")
    check_kernel_inputs(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=torch.float32, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            b, h, n, d, float(scale), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
