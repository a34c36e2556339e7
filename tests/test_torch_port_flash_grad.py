"""The flash-attention kernels of the port against the JAX library's.

The JAX library's Pallas kernels (``jax.experimental.pallas.ops.tpu.
flash_attention``, jax 0.9.0) run here on the CPU in TPU interpret mode, and
the port's plain versions (what its CUDA kernels compute, with the same
decomposition) are held to them on the same numpy inputs:

  (a) the forward's residuals l (row sum) and m (row max); and the CUDA
      forward's design emulated on the bits (each cluster rank's share of
      the key tiles, each key group's online softmax over 3xTF32 scores in
      log2 units, the fixed-order merges) for splits 1, 2 and 4;
  (b) dK/dV and dQ, both fed the same l, m, dout and di; and the CUDA
      kernels' 3xTF32 products, emulated on the bits, from the same inputs;
  (c) dq, dk, dv through the port's autograd Function against ``jax.grad``
      of the library's public ``flash_attention``;
  (d) parameter and input gradients of ``MultiHeadSelfAttention(backend=
      "flash")`` against the JAX module's (its XLA path off a TPU).

Tolerances: (a)-(c) rtol/atol 1e-5, (d) rtol/atol 1e-4: fp32 on both sides,
sums in another order (the TPU kernels' tiles against whole-row matmuls;
(d) also differentiates the projections in another order). Observed on
this suite's inputs: (a) l within 2.4e-7 relative, m exact, out within
4.5e-7, the forward's emulation out within 7.2e-7, l within 1.7e-6
relative, m within 1.9e-6; (b) within 4.8e-7, the 3xTF32 emulation within 1.4e-6 (one TF32
product per matmul: 3e-4 to 9e-4), and (c) within 5.4e-7 absolute; (d)
within 1.2e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu.core import layers as jax_layers
from mclstexp_tpu_torch.core import layers
from mclstexp_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 0.125  # 64 ** -0.5


def _library():
    """The JAX library's flash-attention module and the private names (jax
    0.9.0) that tests (a) and (b) call; a clear error if they moved."""
    from jax.experimental.pallas import tpu as pltpu
    import jax.experimental.pallas.ops.tpu.flash_attention as lib

    names = ("_flash_attention", "_flash_attention_bwd_dkv", "_flash_attention_bwd_dq",
             "BlockSizes", "DEFAULT_MASK_VALUE", "flash_attention")
    missing = [n for n in names if not hasattr(lib, n)]
    if missing or not hasattr(pltpu, "force_tpu_interpret_mode"):
        raise AssertionError(
            f"jax {jax.__version__}: jax.experimental.pallas.ops.tpu.flash_attention lacks "
            f"{missing or 'pltpu.force_tpu_interpret_mode'}; these tests call the private "
            "names of jax 0.9.0 and need updating to the installed version")
    return lib, pltpu.force_tpu_interpret_mode


@pytest.fixture(scope="module", params=[128, 256], ids=lambda n: f"n{n}")
def reference(request):
    """Inputs at (1, 2, n, 64) and everything the JAX library computes from
    them, its Pallas kernels in interpret mode."""
    n = request.param
    lib, interpret = _library()
    r = np.random.default_rng(n)
    q, k, v, do = (r.normal(size=(1, 2, n, 64)).astype(np.float32) for _ in range(4))
    blocks = lib.BlockSizes.get_default(1, 2, n, n, 64)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    with interpret():
        o, l, m = lib._flash_attention(jq, jk, jv, None, None, True, False, SCALE, blocks,
                                       False)
        di = jnp.sum(o * jdo, axis=-1)
        common = dict(sm_scale=SCALE, causal=False, mask_value=lib.DEFAULT_MASK_VALUE,
                      debug=False)
        dk, dv = lib._flash_attention_bwd_dkv(
            jq, jk, jv, None, None, l, m, jdo, di, block_q_major=blocks.block_q_major_dkv,
            block_q=blocks.block_q_dkv, block_k_major=blocks.block_k_major_dkv,
            block_k=blocks.block_k_dkv, **common)
        dq, _ = lib._flash_attention_bwd_dq(
            jq, jk, jv, None, None, l, m, jdo, di, block_q_major=blocks.block_q_dq,
            block_k_major=blocks.block_k_major_dq, block_k=blocks.block_k_dq, **common)
        grads = jax.grad(
            lambda a, b, c: jnp.sum(lib.flash_attention(a, b, c, sm_scale=SCALE) * jdo),
            argnums=(0, 1, 2))(jq, jk, jv)
    got = lambda x: np.array(x)  # noqa: E731
    return dict(inputs=(q, k, v, do), o=got(o), l=got(l), m=got(m), di=got(di), dk=got(dk),
                dv=got(dv), dq=got(dq), grads=tuple(map(got, grads)))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_forward_residuals_match_the_library(reference):
    """(a) the port's plain forward keeps the TPU kernel's l and m."""
    q, k, v, _ = map(_t, reference["inputs"])
    out, l, m = fa.flash_forward_plain(q, k, v, SCALE)
    assert l.shape == m.shape == q.shape[:3] and l.dtype == m.dtype == torch.float32
    np.testing.assert_allclose(l.numpy(), reference["l"], **TOL)
    np.testing.assert_allclose(m.numpy(), reference["m"], **TOL)
    np.testing.assert_allclose(out.numpy(), reference["o"], **TOL)


def test_backward_kernels_plain_versions_match_the_library(reference):
    """(b) dK/dV and dQ from the same l, m, dout and di as the library's
    Pallas kernels."""
    q, k, v, do = map(_t, reference["inputs"])
    l, m, di = (_t(reference[x]) for x in ("l", "m", "di"))
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, l, m, di, SCALE)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, l, m, di, SCALE)
    for name, got in (("dk", dk), ("dv", dv), ("dq", dq)):
        np.testing.assert_allclose(got.numpy(), reference[name], err_msg=name, **TOL)
    # the wrappers take the plain versions for CPU tensors and launch nothing
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    torch.testing.assert_close(fa.flash_bwd_dkv(q, k, v, do, l, m, di, SCALE), (dk, dv),
                               rtol=0, atol=0)
    torch.testing.assert_close(fa.flash_bwd_dq(q, k, v, do, l, m, di, SCALE), dq,
                               rtol=0, atol=0)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == before


def _tf32(x):
    """``cvt.rna.tf32.f32`` on the bits: round to 10 mantissa bits, ties
    away from zero (add half of the dropped part's range, clear it)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the CUDA kernels multiply on the tensor cores: each operand
    split into big = tf32(x) and small = tf32(x - big), and big @ big +
    (small @ big + big @ small) in fp32; small @ small dropped."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return ab @ bb + (a_s @ bb + ab @ b_s)


def _backward_with(mm, q, k, v, do, l, m, di):
    """dK, dV and dQ with every product taken by ``mm``, p and ds formed in
    fp32 as the kernels form them."""
    p = torch.exp(mm(q, k.transpose(-1, -2)) * SCALE - m[..., None]) * (1.0 / l)[..., None]
    ds = p * (mm(do, v.transpose(-1, -2)) - di[..., None]) * SCALE
    return mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do), mm(ds, k)


def test_3xtf32_products_match_the_library(reference):
    """The kernels' 3xTF32 split, emulated here, keeps dK, dV and dQ within
    1e-5 of the library's Pallas kernels; one TF32 product per matmul (the
    split's big parts alone) misses that by far: the split is needed."""
    q, k, v, do = map(_t, reference["inputs"])
    l, m, di = (_t(reference[x]) for x in ("l", "m", "di"))
    assert _tf32(torch.tensor([1.0 + 2.0**-11, -(1.0 + 3 * 2.0**-11)])).tolist() == [
        1.0 + 2.0**-10, -(1.0 + 2 * 2.0**-10)]  # ties go away from zero
    split = _backward_with(_mm_3xtf32, q, k, v, do, l, m, di)
    single = _backward_with(lambda a, b: _tf32(a) @ _tf32(b), q, k, v, do, l, m, di)
    for name, got, rough in zip(("dk", "dv", "dq"), split, single):
        np.testing.assert_allclose(got.numpy(), reference[name], err_msg=name, **TOL)
        assert np.abs(rough.numpy() - reference[name]).max() > 1e-4, name


LOG2E = np.float32(np.log2(np.e))  # the forward kernel keeps scores in log2 units
LN2 = np.float32(np.log(2.0))


def _merge(parts):
    """(m, l, acc) parts merged as the forward kernel merges them, in list
    order, maxima in log2 units: m = max m_i, l = sum l_i 2^(m_i - m), acc =
    sum acc_i 2^(m_i - m); a part that saw no valid key (m_i = -inf) weighs
    0."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = torch.where(m_i == -torch.inf, 0.0, torch.exp2(m_i - m))
        l, acc = l + l_i * w, acc + acc_i * w[..., None]
    return m, l, acc


def _emulated_forward(q, k, v, split):
    """The forward kernel's arithmetic on the bits: rank r of a cluster walks
    key tiles [r * T // split, (r + 1) * T // split) of T = ceil(n / 32); in
    each tile, key group j (keys 8j..8j+7 of the tile) keeps its own running
    max, sum and output per query row, with s = q k^T and p v as 3xTF32
    products, scores in log2 units (s * scale * log2(e), exp2); the groups
    merge in group order into the rank's (m, l, acc), the ranks in rank
    order; out = acc / l, and m back in natural units."""
    n = q.shape[2]
    tiles = -(-n // 32)
    ranks = []
    for r in range(split):
        groups = []
        for j in range(4):
            m = torch.full(q.shape[:3], -torch.inf)
            l, acc = torch.zeros(q.shape[:3]), torch.zeros(q.shape)
            for tile in range(r * tiles // split, (r + 1) * tiles // split):
                keys = slice(tile * 32 + 8 * j, min(tile * 32 + 8 * j + 8, n))
                if keys.start >= n:  # every key masked: p = 0, and alpha 1 (or 0 at m = -inf)
                    continue
                s = _mm_3xtf32(q, k[:, :, keys].transpose(-1, -2)) * (SCALE * LOG2E)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.where(m == -torch.inf, 0.0, torch.exp2(m - m_new))
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + _mm_3xtf32(p, v[:, :, keys])
                m = m_new
            groups.append((m, l, acc))
        ranks.append(_merge(groups))
    m, l, acc = _merge(ranks)
    return acc / l[..., None], l, m * LN2


@pytest.mark.parametrize("split", [1, 2, 4])
def test_forward_kernel_emulation_matches_the_library(reference, split):
    """The forward kernel's design (per-rank, per-key-group online softmax
    over 3xTF32 scores in log2 units, then the fixed-order merges), emulated
    here, keeps
    out, l and m within 1e-5 of the library's Pallas forward, whatever the
    split of the key walk."""
    q, k, v, _ = map(_t, reference["inputs"])
    out, l, m = _emulated_forward(q, k, v, split)
    np.testing.assert_allclose(out.numpy(), reference["o"], err_msg="out", **TOL)
    np.testing.assert_allclose(l.numpy(), reference["l"], err_msg="l", **TOL)
    np.testing.assert_allclose(m.numpy(), reference["m"], err_msg="m", **TOL)


def test_autograd_function_matches_jax_grad(reference):
    """(c) the port's Function on the CPU against jax.grad of the public
    flash_attention, through strided views of one qkv buffer as the spot
    tower gives them."""
    q, k, v, do = reference["inputs"]
    qkv = torch.from_numpy(np.stack([x.transpose(0, 2, 1, 3) for x in (q, k, v)], axis=2))
    qkv.requires_grad_()
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    out = fa.flash_attention(*views, SCALE)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * _t(do)).sum().backward()
    for i, name in enumerate(("dq", "dk", "dv")):
        got = qkv.grad[:, :, i].transpose(1, 2).numpy()
        np.testing.assert_allclose(got, reference["grads"][i], err_msg=name, **TOL)


def test_function_is_once_differentiable():
    """Higher-order AD raises, as it does in the JAX library."""
    q = torch.randn((1, 1, 4, 8), requires_grad=True, generator=torch.Generator().manual_seed(0))
    out = fa.flash_attention(q, q, q, 0.5)
    (g,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), q)


@pytest.mark.parametrize("n", [1, 50, 128])
def test_flash_module_gradients_match_jax(n):
    """(d) MultiHeadSelfAttention(backend="flash") gradients of its
    parameters and its input against jax.grad of the JAX module."""
    r = np.random.default_rng(n)
    x = r.normal(size=(1, n, 24)).astype(np.float32)
    cot = r.normal(size=(1, n, 24)).astype(np.float32)
    jmod = jax_layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, backend="flash")
    params = jax.device_get(jmod.init(jax.random.PRNGKey(n), x))["params"]

    def loss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) * cot)

    jgrad_p, jgrad_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    tmod = layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, device="cpu",
                                         backend="flash")
    with torch.no_grad():
        tmod.to_qkv.weight.copy_(torch.from_numpy(np.array(params["to_qkv"]["kernel"].T)))
        tmod.to_out[0].weight.copy_(torch.from_numpy(np.array(params["to_out"]["kernel"].T)))
        tmod.to_out[0].bias.copy_(torch.from_numpy(np.array(params["to_out"]["bias"])))
    tx = torch.from_numpy(x).requires_grad_()
    (tmod(tx) * torch.from_numpy(cot)).sum().backward()
    pairs = (("x", tx.grad, jgrad_x),
             ("to_qkv", tmod.to_qkv.weight.grad.T, jgrad_p["to_qkv"]["kernel"]),
             ("to_out", tmod.to_out[0].weight.grad.T, jgrad_p["to_out"]["kernel"]),
             ("to_out.bias", tmod.to_out[0].bias.grad, jgrad_p["to_out"]["bias"]))
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **MODULE_TOL)
