"""The host's cost of one flash-kernel launch, at the training shape, on the card.

    python -m mclstexp_tpu_torch.profile_launch

At (b, h, n, d) = (1, 8, 128, 64), on the views of a (b, n, 3, h, d) qkv
buffer as the spot tower gives them, times on the host clock
(``time.perf_counter``) how long one eager call takes to return, over
windows of 1,000 calls after a synchronize (the kernels take a few
microseconds on the card, less than a call takes on the host, so the
queue stays short and the window measures the host), median of 5 windows:
  * ``bwd_dkv_entry``, ``bwd_dq_entry``: the backward kernels' C entry points
    called through ctypes with prepared arguments (strides array, plan
    rows 32 and split 4, the current stream): the launch alone;
  * ``flash_bwd_dkv``, ``flash_bwd_dq``, ``flash_forward`` (with residuals):
    the Python wrappers (checks, output allocation, plan, launch, count);
  * ``pair``: forward with residuals + di + dK/dV + dQ, as the autograd
    Function runs them;
  * the same in bfloat16 (``*_bf16``), the forward's C entry point too: the
    bf16 forward and dK/dV entry points encode a TMA tensor map per input
    view (under ``bf16_plan``; a checkout without it, under
    ``cluster_plan``).
Prints one JSON object of microseconds per call, with the card's name and
power limit. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import time

import torch

from mclstexp_tpu_torch.ops import flash_attention as fa

SHAPE = (1, 8, 128, 64)
PLAN = (32, 4)  # cluster_plan at SHAPE: rows, split
CALLS, WINDOWS = 1000, 5


def _host_us(fn) -> float:
    """Median over WINDOWS of the host's microseconds per call of ``fn``."""
    for _ in range(20):
        fn()
    windows = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        windows.append((time.perf_counter() - t0) / CALLS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(windows)


def _plan(dtype, warpgroup: bool) -> tuple:
    """(rows, split) of a C entry point at SHAPE: ``cluster_plan``'s, or
    ``bf16_plan``'s for the bf16 forward and dK/dV (``warpgroup``) of a
    checkout that has it."""
    if warpgroup and dtype == torch.bfloat16 and hasattr(fa, "bf16_plan"):
        return fa.bf16_plan(*SHAPE)[:2]
    return PLAN


def _time_dtype(dtype, qkv, do, l, m, di, scale) -> dict:
    """Host microseconds per call of the entry points and wrappers in
    ``dtype`` (keys suffixed ``_bf16`` for bf16)."""
    b, h, n, d = SHAPE
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    dk, dv, dq, out = (torch.empty_like(do) for _ in range(4))
    dkv_entry, dq_entry = fa._bwd_entries(dtype)
    fwd_entry = fa._fwd_entry(dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(fn, ptrs, tensors, warpgroup=False):
        strides = (ctypes.c_longlong * (3 * len(tensors)))(
            *(s for t in tensors for s in t.stride()[:3]))
        args = (*ptrs, None, strides, b, h, n, d, *_plan(dtype, warpgroup), scale, stream)

        def call():
            if fn(*args) != 0:
                raise RuntimeError("flash launch failed")
        return call

    inputs = [t.data_ptr() for t in (q, k, v, do, l, m, di)]
    fwd_ptrs = [t.data_ptr() for t in (q, k, v, out, l, m)]
    bwd = (q, k, v, do)

    def pair():
        o, ll, mm = fa.flash_forward(q, k, v, scale, residuals=True)
        dd = (o.float() * do.float()).sum(-1).contiguous()
        fa.flash_bwd_dkv(q, k, v, do, ll, mm, dd, scale)
        fa.flash_bwd_dq(q, k, v, do, ll, mm, dd, scale)

    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    result = {
        "bwd_dkv_entry": _host_us(entry(dkv_entry, inputs + [dk.data_ptr(), dv.data_ptr()],
                                        (*bwd, dk, dv), True)),
        "bwd_dq_entry": _host_us(entry(dq_entry, inputs + [dq.data_ptr()], (*bwd, dq))),
        "flash_bwd_dkv": _host_us(lambda: fa.flash_bwd_dkv(q, k, v, do, l, m, di, scale)),
        "flash_bwd_dq": _host_us(lambda: fa.flash_bwd_dq(q, k, v, do, l, m, di, scale)),
        "flash_forward": _host_us(lambda: fa.flash_forward(q, k, v, scale, residuals=True)),
        "pair": _host_us(pair),
    }
    if dtype == torch.bfloat16:
        result["fwd_entry"] = _host_us(entry(fwd_entry, fwd_ptrs, (q, k, v, out), True))
    return {key + sfx: us for key, us in result.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_launch: needs a CUDA device")
    b, h, n, d = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda")
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(SHAPE, generator=g, device="cuda")
    scale = d**-0.5
    out, l, m = fa.flash_forward(q, k, v, scale, residuals=True)
    di = (out * do).sum(-1).contiguous()

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        result.update(_time_dtype(dtype, qkv.to(dtype), do.to(dtype), l, m, di, scale))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout
    print(json.dumps({"card": card.strip().splitlines()[0], "shape": list(SHAPE),
                      "host_us_per_call": result}), flush=True)


if __name__ == "__main__":
    main()
