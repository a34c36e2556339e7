"""Spot attention backends: the port's ``MultiHeadSelfAttention(backend=)``
against the JAX module, and the flash wrapper's CPU path and shape rule.

On the CPU "flash" runs the plain fp32-softmax path (the JAX module does
the same off a TPU), so "flash" in the port equals the JAX module run with
``backend="flash"`` on the CPU. Float math is held to rtol/atol 1e-5 (both
fp32; only the summation order differs). "ring" raises in the port: it has
no device mesh yet, and the JAX module raises without one too. The CUDA
kernel itself is tested on the card (``tests/test_torch_port_kernels.py``).
"""

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.core import layers as jax_layers
from mclstexp_tpu.models.mclstexp import MclSTExp as JaxMclSTExp
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.core import layers
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, head_layers=2, pos_vocab=64, dense_block_impl="concat")


def _mhsa_pair(backend, x, mask=None, seed=0):
    """(JAX module output, port module) with the same weights."""
    jmod = jax_layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, backend=backend)
    p = jax.device_get(jmod.init(jax.random.PRNGKey(seed), x, mask=mask))["params"]
    want = np.asarray(jmod.apply({"params": p}, x, mask=mask))
    tmod = layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, device="cpu",
                                         backend=backend)
    with torch.no_grad():
        tmod.to_qkv.weight.copy_(torch.from_numpy(np.array(p["to_qkv"]["kernel"].T)))
        tmod.to_out[0].weight.copy_(torch.from_numpy(np.array(p["to_out"]["kernel"].T)))
        tmod.to_out[0].bias.copy_(torch.from_numpy(np.array(p["to_out"]["bias"])))
    return want, tmod


@pytest.mark.parametrize("n", [1, 32, 50])
def test_flash_backend_on_cpu_matches_jax_flash(n):
    x = np.random.default_rng(n).normal(size=(1, n, 24)).astype(np.float32)
    want, tmod = _mhsa_pair("flash", x)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_backend_with_mask_on_cpu_matches_jax():
    x = np.random.default_rng(9).normal(size=(2, 6, 24)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 0]], bool)
    want, tmod = _mhsa_pair("flash", x, mask)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ring_backend_raises_like_jax_without_a_mesh():
    """The JAX module needs an active mesh for "ring" and raises without
    one; the port has no mesh yet and raises for every "ring" module."""
    x = np.zeros((1, 8, 24), np.float32)
    jmod = jax_layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, backend="ring")
    with pytest.raises(ValueError, match="mesh"):
        jmod.init(jax.random.PRNGKey(0), x)
    with pytest.raises(NotImplementedError, match="ring"):
        layers.MultiHeadSelfAttention(24, heads=2, dim_head=16, device="cpu", backend="ring")
    with pytest.raises(NotImplementedError, match="ring"):
        MclSTExp(config.ModelConfig(**{**TINY, "attn_backend": "ring"}), device="cpu")
    with pytest.raises(ValueError, match="unknown attention backend"):
        layers.MultiHeadSelfAttention(24, device="cpu", backend="sdpa")


def test_spot_tower_with_flash_matches_jax():
    """The whole spot tower (position tables, 2 blocks, projection) with
    attn_backend="flash", weights carried from the JAX model."""
    kw = {**TINY, "attn_backend": "flash"}
    jm = JaxMclSTExp(jax_config.ModelConfig(**kw))
    r = np.random.default_rng(1)
    batch = {"image": r.uniform(size=(32, 16, 16, 3)).astype(np.float32),
             "expression": r.normal(size=(32, 24)).astype(np.float32),
             "position": r.integers(0, 64, size=(32, 2)).astype(np.int32)}
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), batch, train=False))
    want = jm.apply(variables, batch["expression"], batch["position"],
                    method=JaxMclSTExp.encode_spots)
    cfg = config.ModelConfig(**kw)
    tm = MclSTExp(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"], cfg),
                       strict=True)
    assert all(m.fn.backend == "flash" for m in (b.attn for b in tm.spot_encoder))
    with torch.no_grad():
        got = tm.encode_spots(torch.from_numpy(batch["expression"]),
                              torch.from_numpy(batch["position"]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    """A CPU tensor goes to attention_plain, strided qkv views included,
    and launches nothing."""
    r = np.random.default_rng(2)
    qkv = torch.from_numpy(r.normal(size=(2, 37, 3, 4, 16)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, 0.25)
    assert fa.flash_attention.launches == before
    want = fa.attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), 0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the plain version is softmax(q k^T * scale) v
    ref = torch.softmax(q @ k.transpose(-1, -2) * 0.25, dim=-1) @ v
    torch.testing.assert_close(got, ref, **TOL)


def test_flash_kernel_shape_rule():
    """What the CUDA kernel takes (checked before any launch): one (b, h, n,
    d) shape, float32, 1 <= d <= 128, any n >= 1, last dimension
    contiguous."""
    ok = torch.zeros((1, 8, 300, 64))
    fa.check_kernel_inputs(ok, ok, ok)
    fa.check_kernel_inputs(*(torch.zeros((2, 3, 1, 128)),) * 3)
    with pytest.raises(ValueError, match="d <= 128"):
        fa.check_kernel_inputs(*(torch.zeros((1, 1, 4, 129)),) * 3)
    with pytest.raises(TypeError, match="float32"):
        fa.check_kernel_inputs(*(torch.zeros((1, 1, 4, 8), dtype=torch.float16),) * 3)
    with pytest.raises(ValueError, match="one \\(b, h, n, d\\) shape"):
        fa.check_kernel_inputs(ok, ok, ok[:, :, :299])
    with pytest.raises(ValueError, match="non-empty"):
        fa.check_kernel_inputs(*(torch.zeros((1, 1, 0, 8)),) * 3)
    strided = torch.zeros((1, 1, 4, 16))[..., ::2]
    with pytest.raises(ValueError, match="last dimension contiguous"):
        fa.check_kernel_inputs(strided, strided, strided)


def test_kernel_inputs_take_bf16_of_one_type():
    """bf16 q, k, v pass the kernels' shape rule; mixed or half types raise."""
    x = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    fa.check_kernel_inputs(x, x, x)
    with pytest.raises(TypeError, match="one type"):
        fa.check_kernel_inputs(x, x, x.float())
    with pytest.raises(TypeError, match="bfloat16"):
        fa.check_kernel_inputs(*(x.half(),) * 3)


BWD_PLAN_SHAPES = [(1, 8, 128, 64), (1, 8, 66, 64), (1, 8, 300, 64), (1, 16, 4096, 64),
                   (1, 1, 1000, 64), (2, 4, 1, 16), (1, 1, 33, 128), (64, 8, 128, 64)]


@pytest.mark.parametrize("shape", BWD_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_plan_covers_every_row_once_and_fills_the_card(shape):
    """The backward kernels' grid plan: blocks of ``rows`` cover the n rows
    of each head once; the split's shares of the walked tiles (rank r walks
    [r * T // split, (r + 1) * T // split)) and of the reduced block rows
    ([r * rows // split, ...)) cover each once, every rank with at least one
    tile; 1 <= split <= min(8, T); 132 CTAs or more unless split is at its
    cap, and no smaller split reaches 132."""
    b, h, n, d = shape
    rows, split, ctas = fa.cluster_plan(b, h, n, d)
    tiles = -(-n // rows)
    assert rows == 32 and (tiles - 1) * rows < n <= tiles * rows
    cap = min(8, tiles)
    assert 1 <= split <= cap and ctas == b * h * tiles * split
    assert ctas >= 132 or split == cap
    assert split == 1 or b * h * tiles * (split - 1) < 132
    for count, parts in ((tiles, split), (rows, split)):
        shares = [range(r * count // parts, (r + 1) * count // parts) for r in range(parts)]
        assert sorted(i for s in shares for i in s) == list(range(count))
        assert all(len(s) >= 1 for s in shares)


def test_bwd_plan_at_the_spot_tower_and_whole_slide_shapes():
    """The training shape fills the card with 4 splits of its 4 tiles (128
    CTAs, from 32 blocks); the remainder batch and a ragged length split 3
    and 2 ways; (1, 1, 1000, 64) 5 ways, 6-7 tiles each with a ragged last
    tile of 8 rows; the whole-slide width (2,048 blocks) needs no split."""
    assert fa.cluster_plan(1, 8, 128, 64) == (32, 4, 128)
    assert fa.cluster_plan(1, 8, 66, 64) == (32, 3, 72)
    assert fa.cluster_plan(1, 8, 300, 64) == (32, 2, 160)
    assert fa.cluster_plan(1, 1, 1000, 64) == (32, 5, 160)
    assert 1000 % 32 == 8 and [(r + 1) * 32 // 5 - r * 32 // 5 for r in range(5)] == [6, 6, 7,
                                                                                      6, 7]
    assert fa.cluster_plan(1, 16, 4096, 64) == (32, 1, 2048)


@pytest.mark.parametrize("shape, match", [
    ((1, 8, 128, 0), "d <= 128"), ((1, 8, 128, 129), "d <= 128"), ((0, 8, 128, 64), "n >= 1"),
    ((1, 8, 0, 64), "n >= 1"), ((1, 1, 65535 * 32 + 1, 64), "n <= 2097120"),
    ((2**20, 2**11, 32, 64), "2\\*\\*31")])
def test_bwd_plan_raises_outside_the_kernels_limits(shape, match):
    with pytest.raises(ValueError, match=match):
        fa.cluster_plan(*shape)


# The forward's plans (split, CTAs): the training shape, the remainder batch,
# a ragged length, the whole-slide width and the eval sweep's batch of 32.
FWD_PLANS = {(1, 8, 128, 64): (4, 128), (1, 8, 66, 64): (3, 72), (1, 8, 300, 64): (2, 160),
             (1, 16, 4096, 64): (1, 2048), (1, 8, 32, 64): (1, 8)}


@pytest.mark.parametrize("shape", FWD_PLANS, ids=lambda s: "x".join(map(str, s)))
def test_forward_plan_covers_every_query_row_once(shape):
    """The forward kernel's plan (``cluster_plan``, shared with the
    backward): query blocks of 32 cover each of the n rows once; the ranks'
    shares of the key tiles cover each tile once, each share starting at a
    valid key (only the last tile is ragged); the ranks' merged rows cover
    the block's 32 rows once; the split and CTAs expected at each shape."""
    b, h, n, d = shape
    rows, split, ctas = fa.cluster_plan(*shape)
    assert (split, ctas) == FWD_PLANS[shape]
    tiles = -(-n // rows)
    assert ctas == b * h * tiles * split
    blocks = [range(y * rows, min((y + 1) * rows, n)) for y in range(tiles)]
    assert sorted(i for blk in blocks for i in blk) == list(range(n))
    shares = [range(r * tiles // split, (r + 1) * tiles // split) for r in range(split)]
    assert sorted(i for s in shares for i in s) == list(range(tiles))
    assert all(len(s) >= 1 and s[0] * rows < n for s in shares)
    merged = [range(r * rows // split, (r + 1) * rows // split) for r in range(split)]
    assert sorted(i for s in merged for i in s) == list(range(rows))


@pytest.mark.parametrize("shape, match", [
    ((1, 8, 128, 0), "d <= 128"), ((1, 8, 128, 129), "d <= 128"), ((0, 8, 128, 64), "non-empty"),
    ((1, 8, 0, 64), "non-empty"), ((1, 1, 65535 * 32 + 1, 64), "n <= 2097120"),
    ((2**20, 2**11, 32, 64), "2\\*\\*31")])
def test_forward_plan_raises_outside_the_kernels_limits(shape, match):
    """What ``flash_forward`` checks before a launch, in its order: the
    shape rule (``check_kernel_inputs``), then the plan."""
    x = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_inputs(x, x, x)
        fa.cluster_plan(*shape)


def test_kernel_build_digest_follows_included_headers(tmp_path, monkeypatch):
    """A kernel library's name hashes its source and the csrc headers it
    includes, through other headers, so an edited header rebuilds."""
    from mclstexp_tpu_torch.ops import build

    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.source_digest("k.cu")
    assert build.source_digest("k.cu") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = build.source_digest("k.cu")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert len({first, second, build.source_digest("k.cu")}) == 3
    # both of the port's flash sources include the shared header
    monkeypatch.undo()
    for source in (fa.SOURCE, fa.BWD_SOURCE):
        assert b'#include "flash_common.cuh"' in (build.CSRC / source).read_bytes()
