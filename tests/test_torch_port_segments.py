"""The segment-id branch of the port's flash kernels against the JAX library.

The JAX package reaches the library's flash kernels with
``SegmentIds(q=m, kv=m)``, ``m = int32(mask)``, whenever a padded slide's
mask meets ``backend="flash"`` on a TPU (``mclstexp_tpu/core/layers.py:
207-219``). Here the library's Pallas kernels run on the CPU in TPU
interpret mode with segment ids, and the port's plain versions with the
same ids (what its CUDA kernels compute) are held to them on the same numpy
inputs at (1, 2, n, 64), n = 128 and 256, with padded tails of 1, 56 and
127 rows and with interleaved ids:

  (a) the forward's out and residuals l and m; and the CUDA forward's
      design emulated on the bits with the segment predicate (per cluster
      rank and key group an online softmax over 3xTF32 scores, then the
      fixed-order merges; splits 1, 2 and 4, where some rank sees no key of
      a row's segment), finite and within tolerance;
  (b) dK/dV and dQ, fed the library's l, m and di;
  (c) dq, dk, dv through the port's ``FlashAttention`` Function with ids
      against ``jax.grad`` of the library's public ``flash_attention``;
  (d) a mask on the CPU: ``flash_attention`` keeps the key mask, what the
      JAX module computes off a TPU (its XLA path).

Tolerances: rtol/atol 1e-5 for (a)-(c) (fp32 on both sides, sums in
another order), 1e-4 for the module in (d), as in
``test_torch_port_flash_grad.py``, whose library helper and 3xTF32
emulation these tests reuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_flash_grad import LN2, LOG2E, _library, _merge, _mm_3xtf32

from mclstexp_tpu.core import layers as jax_layers
from mclstexp_tpu_torch.core import layers
from mclstexp_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 0.125  # 64 ** -0.5
KINDS = ("tail1", "tail56", "tail127", "interleaved")


def _ids(n, kind, r):
    """(1, n) int32 ids: a mask with a padded tail of that many rows as
    int32 (real 1, padded 0), or ids drawn from {0, 1, 2}."""
    if kind == "interleaved":
        return r.integers(0, 3, size=(1, n)).astype(np.int32)
    pad = int(kind[4:])
    return (np.arange(n) < n - pad).astype(np.int32)[None]


@pytest.fixture(scope="module", params=[(n, kind) for n in (128, 256) for kind in KINDS],
                ids=lambda p: f"n{p[0]}-{p[1]}")
def reference(request):
    """Inputs at (1, 2, n, 64), segment ids, and everything the JAX library
    computes from them, its Pallas kernels in interpret mode."""
    n, kind = request.param
    lib, interpret = _library()
    r = np.random.default_rng(n + len(kind))
    q, k, v, do = (r.normal(size=(1, 2, n, 64)).astype(np.float32) for _ in range(4))
    seg = _ids(n, kind, r)
    blocks = lib.BlockSizes.get_default(1, 2, n, n, 64)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    ids = lib.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    with interpret():
        o, l, m = lib._flash_attention(jq, jk, jv, None, ids, True, False, SCALE, blocks, False)
        di = jnp.sum(o * jdo, axis=-1)
        common = dict(sm_scale=SCALE, causal=False, mask_value=lib.DEFAULT_MASK_VALUE,
                      debug=False)
        dk, dv = lib._flash_attention_bwd_dkv(
            jq, jk, jv, None, ids, l, m, jdo, di, block_q_major=blocks.block_q_major_dkv,
            block_q=blocks.block_q_dkv, block_k_major=blocks.block_k_major_dkv,
            block_k=blocks.block_k_dkv, **common)
        dq, _ = lib._flash_attention_bwd_dq(
            jq, jk, jv, None, ids, l, m, jdo, di, block_q_major=blocks.block_q_dq,
            block_k_major=blocks.block_k_major_dq, block_k=blocks.block_k_dq, **common)
        grads = jax.grad(
            lambda a, b, c: jnp.sum(lib.flash_attention(a, b, c, segment_ids=ids,
                                                        sm_scale=SCALE) * jdo),
            argnums=(0, 1, 2))(jq, jk, jv)
    got = lambda x: np.array(x)  # noqa: E731
    return dict(inputs=(q, k, v, do), kind=kind, seg=seg, o=got(o), l=got(l), m=got(m),
                di=got(di), dk=got(dk), dv=got(dv), dq=got(dq), grads=tuple(map(got, grads)))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_segment_forward_matches_the_library(reference):
    """(a) out, l and m of the plain forward with segment ids; and the padded
    rows attend to padded keys only (the key mask's answer differs)."""
    q, k, v, _ = map(_t, reference["inputs"])
    seg = _t(reference["seg"])
    out, l, m = fa.flash_forward_plain(q, k, v, SCALE, seg)
    for name, got in (("o", out), ("l", l), ("m", m)):
        np.testing.assert_allclose(got.numpy(), reference[name], err_msg=name, **TOL)
    padded = (seg[0] == 0).numpy()
    if padded.any() and not padded.all():
        key_mask = fa.attention_plain(q, k, v, SCALE, seg != 0).numpy()
        assert np.abs(key_mask[:, :, padded] - reference["o"][:, :, padded]).max() > 1e-2


def test_segment_backward_plain_versions_match_the_library(reference):
    """(b) dK/dV and dQ with segment ids from the library's l, m, dout, di;
    the wrappers take the plain versions for CPU tensors and launch
    nothing."""
    q, k, v, do = map(_t, reference["inputs"])
    l, m, di, seg = (_t(reference[x]) for x in ("l", "m", "di", "seg"))
    counts = lambda: [(w.launches, w.segment_launches)  # noqa: E731
                      for w in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    before = counts()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, l, m, di, SCALE, seg)
    dq = fa.flash_bwd_dq(q, k, v, do, l, m, di, SCALE, seg)
    assert counts() == before
    for name, got in (("dk", dk), ("dv", dv), ("dq", dq)):
        np.testing.assert_allclose(got.numpy(), reference[name], err_msg=name, **TOL)


def test_segment_function_matches_jax_grad(reference):
    """(c) the Function with segment ids on the CPU against jax.grad of the
    library's public flash_attention, through the views of one qkv
    buffer."""
    q, k, v, do = reference["inputs"]
    qkv = torch.from_numpy(np.stack([x.transpose(0, 2, 1, 3) for x in (q, k, v)], axis=2))
    qkv.requires_grad_()
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    out = fa.FlashAttention.apply(*views, SCALE, _t(reference["seg"]))
    np.testing.assert_allclose(out.detach().numpy(), reference["o"], **TOL)
    (out * _t(do)).sum().backward()
    for i, name in enumerate(("dq", "dk", "dv")):
        got = qkv.grad[:, :, i].transpose(1, 2).numpy()
        np.testing.assert_allclose(got, reference["grads"][i], err_msg=name, **TOL)


def _emulated_segment_forward(q, k, v, seg, split):
    """The forward kernel's arithmetic with segment ids: as
    ``test_torch_port_flash_grad._emulated_forward``, the score of row i and
    key j kept only where seg[i] == seg[j] (p = 0 and no part of the max
    elsewhere). Returns (out, l, m) and the number of (rank, row) pairs that
    saw no key of the row's segment."""
    n = q.shape[2]
    tiles = -(-n // 32)
    same = fa.same_segment(seg)  # (1, 1, n, n)
    ranks, empty = [], 0
    for r in range(split):
        groups = []
        for j in range(4):
            m = torch.full(q.shape[:3], -torch.inf)
            l, acc = torch.zeros(q.shape[:3]), torch.zeros(q.shape)
            for tile in range(r * tiles // split, (r + 1) * tiles // split):
                keys = slice(tile * 32 + 8 * j, min(tile * 32 + 8 * j + 8, n))
                if keys.start >= n:
                    continue
                ok = same[..., keys]
                s = _mm_3xtf32(q, k[:, :, keys].transpose(-1, -2)) * (SCALE * LOG2E)
                s = torch.where(ok, s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.where(m == -torch.inf, 0.0, torch.exp2(m - m_new))
                p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + _mm_3xtf32(p, v[:, :, keys])
                m = m_new
            groups.append((m, l, acc))
        merged = _merge(groups)
        empty += int((merged[0] == -torch.inf).sum())
        ranks.append(merged)
    m, l, acc = _merge(ranks)
    return (acc / l[..., None], l, m * LN2), empty


@pytest.mark.parametrize("split", [1, 2, 4])
def test_segment_forward_kernel_emulation_matches_the_library(reference, split):
    """The CUDA forward's design with the segment predicate, emulated on the
    bits: finite, and within 1e-5 of the library, whatever the split. With
    a tail of 56 or 127 padded rows and split 4 some rank walks only keys of
    the other segment for a row: its (m, l) stays (-inf, 0) and weighs 0."""
    q, k, v, _ = map(_t, reference["inputs"])
    (out, l, m), empty = _emulated_segment_forward(q, k, v, _t(reference["seg"]), split)
    assert torch.isfinite(out).all() and torch.isfinite(m).all()
    if split == 4 and reference["kind"] in ("tail56", "tail127"):
        assert empty > 0
    np.testing.assert_allclose(out.numpy(), reference["o"], err_msg="out", **TOL)
    np.testing.assert_allclose(l.numpy(), reference["l"], err_msg="l", **TOL)
    np.testing.assert_allclose(m.numpy(), reference["m"], err_msg="m", **TOL)


@pytest.mark.parametrize("n,pad", [(16, 5), (128, 56)])
def test_mask_on_the_cpu_keeps_the_key_mask(n, pad):
    """(d) MultiHeadSelfAttention(backend="flash") with a mask on the CPU,
    forward and gradients, against the JAX module off a TPU (its XLA key
    mask), padded rows included; the plain key mask runs, no Function."""
    r = np.random.default_rng(n)
    x = r.normal(size=(1, n, 24)).astype(np.float32)
    cot = r.normal(size=(1, n, 24)).astype(np.float32)
    mask = np.arange(n) < n - pad
    jmod = jax_layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, backend="flash")
    params = jax.device_get(jmod.init(jax.random.PRNGKey(n), x))["params"]

    def loss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx, mask=jnp.asarray(mask)) * cot)

    want = jmod.apply({"params": params}, x, mask=jnp.asarray(mask))
    jgrad_p, jgrad_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tmod = layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, device="cpu",
                                         backend="flash")
    with torch.no_grad():
        tmod.to_qkv.weight.copy_(torch.from_numpy(np.array(params["to_qkv"]["kernel"].T)))
        tmod.to_out[0].weight.copy_(torch.from_numpy(np.array(params["to_out"]["kernel"].T)))
        tmod.to_out[0].bias.copy_(torch.from_numpy(np.array(params["to_out"]["bias"])))
    tx = torch.from_numpy(x).requires_grad_()
    got = tmod(tx, torch.from_numpy(mask))
    assert "FlashAttention" not in type(got.grad_fn).__name__
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad_x), **MODULE_TOL)
    np.testing.assert_allclose(tmod.to_qkv.weight.grad.T.numpy(),
                               np.asarray(jgrad_p["to_qkv"]["kernel"]), **MODULE_TOL)


def test_segment_ids_are_checked():
    """Segment ids on the CPU need no checks (the plain versions broadcast
    them); the kernels' checker refuses another dtype, shape or device."""
    q = torch.zeros((2, 1, 8, 4))
    fa._check_segments(q, torch.zeros((2, 8), dtype=torch.int32))
    for bad in (torch.zeros((2, 8), dtype=torch.int64), torch.zeros((1, 8), dtype=torch.int32),
                torch.zeros((2, 16), dtype=torch.int32)[:, ::2]):
        with pytest.raises(ValueError, match="segment ids"):
            fa._check_segments(q, bad)
