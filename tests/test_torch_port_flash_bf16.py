"""The bfloat16 branch of the flash-attention kernels against the JAX library's.

With ``ModelConfig.dtype="bfloat16"`` the JAX modules hand the library's
Pallas kernels (``jax.experimental.pallas.ops.tpu.flash_attention``, jax
0.9.0) q, k and v in bf16; the kernels take the scores from bf16 operands
with fp32 sums, round p to bf16 before ``p @ v`` and p^T and ds before the
backward's products, keep l, m and di in fp32 and store out, dk, dv and dq
in bf16. The port's plain bf16 versions do the same casts and are held here
to the library's kernels, run on the CPU in TPU interpret mode on the same
numpy inputs rounded to bf16:

  (a) the forward with its residuals, without and with segment ids;
  (b) dK/dV and dQ from the library's l, m, dout and di;
  (c) the port's autograd Function against ``jax.grad`` of the library's
      public ``flash_attention`` in bf16.

Tolerance: ``2**-7 * max|ref|`` on each bf16 output (about four bf16 ulps
of the largest value): both sides round p (and ds) to bf16 and the outputs
once, but against other running maxima (the library's key blocks against
the whole row here) and after fp32 sums in another order, so a value can
land on the other side of a bf16 rounding boundary. l and m are fp32 on
both sides: rtol 1e-5.

The card tests (``gpu`` marker, skipped without a card) hold the CUDA bf16
kernels to the plain bf16 versions at the shapes of chip_smoke's [bf16]
phase and at d 32 / 64 / 128 and n 1 / 66 / 300, with the same tolerance
plus 1e-5 absolute (at n = 1 dk and dq are rounding noise around 0), and
check that two runs give the same bits. JAX is imported inside the CPU
fixture, so the card tests run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_flash_bf16.py -m gpu
"""

import numpy as np
import pytest
import torch

from mclstexp_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

SCALE = 0.125  # 64 ** -0.5
REL = 2.0**-7
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def _ids(n, kind, r):
    if kind == "none":
        return None
    if kind == "interleaved":
        return r.integers(0, 3, size=(1, n)).astype(np.int32)
    return (np.arange(n) < n - int(kind[4:])).astype(np.int32)[None]


KINDS = ("none", "tail56", "interleaved")


@pytest.fixture(scope="module", params=[(n, kind) for n in (128, 256) for kind in KINDS],
                ids=lambda p: f"n{p[0]}-{p[1]}")
def reference(request):
    """bf16 inputs at (1, 2, n, 64), segment ids or none, and what the JAX
    library computes from them in bf16, its Pallas kernels in interpret
    mode."""
    import jax
    import jax.numpy as jnp
    from test_torch_port_flash_grad import _library

    n, kind = request.param
    lib, interpret = _library()
    r = np.random.default_rng(n + len(kind))
    q, k, v, do = (r.normal(size=(1, 2, n, 64)).astype(np.float32) for _ in range(4))
    seg = _ids(n, kind, r)
    ids = None if seg is None else lib.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    blocks = lib.BlockSizes.get_default(1, 2, n, n, 64)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do))
    with interpret():
        o, l, m = lib._flash_attention(jq, jk, jv, None, ids, True, False, SCALE, blocks, False)
        di = jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32), axis=-1)
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
            lambda a, b, c: jnp.sum((lib.flash_attention(a, b, c, segment_ids=ids,
                                                         sm_scale=SCALE) * jdo)
                                    .astype(jnp.float32)),
            argnums=(0, 1, 2))(jq, jk, jv)
    assert o.dtype == dk.dtype == dq.dtype == grads[0].dtype == jnp.bfloat16
    assert l.dtype == m.dtype == jnp.float32
    f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return dict(inputs=(q, k, v, do), seg=seg, o=f32(o), l=f32(l), m=f32(m), di=f32(di),
                dk=f32(dk), dv=f32(dv), dq=f32(dq), grads=tuple(map(f32, grads)))


def _bf16(x):
    return torch.from_numpy(np.asarray(x)).bfloat16()


def _seg(reference):
    seg = reference["seg"]
    return None if seg is None else torch.from_numpy(seg)


def _close(got, want, name):
    """bf16 ``got`` within 2**-7 max|want| of the library's bf16 ``want``."""
    assert got.dtype == torch.bfloat16, name
    err = np.abs(got.float().numpy() - want).max()
    assert err <= REL * np.abs(want).max(), (name, err, np.abs(want).max())


def test_bf16_forward_matches_the_library(reference):
    """(a) out in bf16, l and m in fp32."""
    q, k, v, _ = map(_bf16, reference["inputs"])
    out, l, m = fa.flash_forward_plain(q, k, v, SCALE, _seg(reference))
    assert l.dtype == m.dtype == torch.float32
    _close(out, reference["o"], "o")
    np.testing.assert_allclose(l.numpy(), reference["l"], **STATS_TOL)
    np.testing.assert_allclose(m.numpy(), reference["m"], **STATS_TOL)


def test_bf16_backward_plain_versions_match_the_library(reference):
    """(b) dK/dV and dQ from the library's l, m, dout and di; on CPU tensors
    the wrappers take the plain versions and launch nothing."""
    q, k, v, do = map(_bf16, reference["inputs"])
    l, m, di = (torch.from_numpy(reference[x]) for x in ("l", "m", "di"))
    counts = lambda: [(w.launches, w.bf16_launches)  # noqa: E731
                      for w in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    before = counts()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, l, m, di, SCALE, _seg(reference))
    dq = fa.flash_bwd_dq(q, k, v, do, l, m, di, SCALE, _seg(reference))
    assert counts() == before
    for name, got in (("dk", dk), ("dv", dv), ("dq", dq)):
        _close(got, reference[name], name)


def test_bf16_function_matches_jax_grad(reference):
    """(c) the Function over the views of one bf16 qkv buffer against
    jax.grad of the library's flash_attention in bf16: the output and the
    three gradients bf16, di in fp32."""
    q, k, v, do = reference["inputs"]
    qkv = torch.from_numpy(np.stack([x.transpose(0, 2, 1, 3) for x in (q, k, v)], axis=2))
    qkv = qkv.bfloat16().requires_grad_()
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    out = fa.FlashAttention.apply(*views, SCALE, _seg(reference))
    _close(out.detach(), reference["o"], "o")
    (out * _bf16(do)).float().sum().backward()
    grads = qkv.grad.permute(2, 0, 3, 1, 4)  # (3, b, h, n, d)
    for name, got, want in zip(("dq", "dk", "dv"), grads, reference["grads"]):
        _close(got, want, name)


def test_bf16_plain_versions_round_where_the_library_does():
    """The plain bf16 forward is not the fp32 forward rounded at the end:
    p is rounded before its product (the library's cast), which moves the
    output by more than the final rounding alone."""
    r = np.random.default_rng(7)
    q, k, v = (_bf16(r.normal(size=(1, 2, 64, 64)).astype(np.float32)) for _ in range(3))
    out, _, _ = fa.flash_forward_plain(q, k, v, SCALE)
    out32, _, _ = fa.flash_forward_plain(q.float(), k.float(), v.float(), SCALE)
    assert not torch.equal(out, out32.bfloat16())
    assert (out.float() - out32).abs().max() <= REL * out32.abs().max()


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _card_case(cuda, b, h, n, d, seg=None):
    """(kernel outputs, plain outputs) of all three bf16 kernels on the
    views of one (b, n, 3, h, d) bf16 buffer; asserts each launch count
    and that a second run gives the same bits."""
    qkv = torch.randn((b, n, 3, h, d), generator=cuda, device="cuda").bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, n, d), generator=cuda, device="cuda").bfloat16()
    scale = d**-0.5
    ro, rl, rm = fa.flash_forward_plain(q, k, v, scale, seg)
    di = (ro.float() * do.float()).sum(-1).contiguous()
    wrappers = (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    before = [w.bf16_launches for w in wrappers]

    def run():
        out, l, m = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, rl, rm, di, scale, seg)
        dq = fa.flash_bwd_dq(q, k, v, do, rl, rm, di, scale, seg)
        return out, l, m, dk, dv, dq

    got = run()
    torch.cuda.synchronize()
    assert [w.bf16_launches for w in wrappers] == [c + 1 for c in before]
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    want = (ro, rl, rm, *fa.flash_bwd_dkv_plain(q, k, v, do, rl, rm, di, scale, seg),
            fa.flash_bwd_dq_plain(q, k, v, do, rl, rm, di, scale, seg))
    return got, want


def _check(got, want, name):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL * want.float().abs().max().item() + 1e-5, (name, err)


SHAPES = [(1, 8, 32, 64), (1, 8, 128, 64), (1, 8, 300, 64), (1, 16, 4096, 64),
          (2, 3, 66, 32), (1, 4, 300, 128), (1, 2, 1, 64), (1, 2, 66, 128), (1, 4, 1, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_kernels_match_plain(cuda, shape):
    got, want = _card_case(cuda, *shape)
    assert got[0].dtype == got[3].dtype == got[5].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(("out", "l", "m", "dk", "dv", "dq"), got, want):
        if name == "l":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        elif name == "m":
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        else:
            _check(g, w, name)


@pytest.mark.gpu
@pytest.mark.parametrize("n,real", [(384, 300), (768, 700), (256, None)])
def test_bf16_kernels_with_segment_ids(cuda, n, real):
    """The slide baselines' padded tails (real rows 1, padded 0) and one
    case of interleaved ids."""
    if real is None:
        seg = torch.randint(0, 3, (1, n), generator=cuda, device="cuda", dtype=torch.int32)
    else:
        seg = (torch.arange(n, device="cuda") < real).int()[None].contiguous()
    before = fa.flash_attention.bf16_segment_launches
    got, want = _card_case(cuda, 1, 16, n, 64, seg)
    assert fa.flash_attention.bf16_segment_launches == before + 2
    for name, g, w in zip(("out", "l", "m", "dk", "dv", "dq"), got, want):
        _check(g, w, name)
