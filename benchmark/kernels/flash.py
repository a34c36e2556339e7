"""Operations and bytes of the port's fp32 flash-attention kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) at one
training call, (b, h, n, d) with segment ids of ``real`` real rows and
``n - real`` padded rows.

From ``chip_smoke.py``'s ``_flash_fwd_bound`` and ``_bwd_kernels``, with
two changes. The work is what these inputs need: the segment ids leave
real rows with real keys and padded rows with padded keys, so a product
covers real^2 + (n - real)^2 query-key pairs, not n^2. The backward is
counted as the pair of kernels needs it, 10 products of pairs x d (S once
to recover P from l and m, then dP, dV, dK, dQ), where the two kernels
recompute S once each (8 + 6); so a redesign that recomputes less cannot
read above 100%. Bytes: each input read once and each output written once
(q, k, v, out and the l and m residuals forward; q, k, v, dout, l, m, di
read and dq, dk, dv written backward; the int32 ids read by each pass).
"""

from __future__ import annotations

F32 = 4


def pairs(n: int, real: int) -> int:
    return real * real + (n - real) * (n - real)


def forward(b: int, h: int, n: int, d: int, real: int):
    """(flops, bytes) of the forward with residuals."""
    flops = 4 * b * h * pairs(n, real) * d
    nbytes = 4 * b * h * n * d * F32 + 2 * b * h * n * F32 + b * n * F32
    return flops, nbytes


def backward(b: int, h: int, n: int, d: int, real: int):
    """(flops, bytes) of dK/dV and dQ together."""
    flops = 10 * b * h * pairs(n, real) * d
    nbytes = 7 * b * h * n * d * F32 + 3 * b * h * n * F32 + 2 * b * n * F32
    return flops, nbytes


def bound_s(b: int, h: int, n: int, d: int, real: int, peaks: dict) -> float:
    """The least time of one training call (forward, dK/dV and dQ): each
    pass the larger of its operations at the TF32 tensor-core peak and its
    bytes at the memory rate."""
    total = 0.0
    for flops, nbytes in (forward(b, h, n, d, real), backward(b, h, n, d, real)):
        total += max(flops / peaks["tf32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    return total
