"""Port parity: layers, loss, model, and the weight bridge ``params_from_jax``.

Each test initializes the JAX module from a seed, carries its variables into
the port with ``params_from_jax`` (strict load), and feeds both the same
numpy inputs. Float math is held to rtol/atol 1e-5: both run fp32 on the
CPU, and only the summation order inside convolutions, matmuls and
reductions differs. The JAX towers run the "concat" dense-block form, the
form the port implements (the piecewise forms re-associate the conv1
channel sum, a further ~1e-5 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.core import layers as jax_layers
from mclstexp_tpu.core.losses import symmetric_infonce as jax_infonce
from mclstexp_tpu.models.image.torch_export import export_reference_state_dict
from mclstexp_tpu.models.mclstexp import MclSTExp as JaxMclSTExp
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.core import layers
from mclstexp_tpu_torch.core.losses import symmetric_infonce
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, pos_vocab=64, dense_block_impl="concat")


def _batch(seed, n=8, patch=16, genes=24, vocab=64):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.uniform(size=(n, patch, patch, 3)).astype(np.float32),
        "expression": rng.normal(size=(n, genes)).astype(np.float32),
        "position": rng.integers(0, vocab, size=(n, 2)).astype(np.int32),
    }


def _pair(seed=0, **overrides):
    """(jax model, its variables, port model loaded from them)."""
    kw = {**TINY, **overrides}
    jm = JaxMclSTExp(jax_config.ModelConfig(**kw))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed), _batch(seed), train=False))
    cfg = config.ModelConfig(**kw)
    tm = MclSTExp(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"], cfg),
                       strict=True)
    return jm, variables, tm


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("variant", ["attention", "mlp"])
def test_model_eval_matches_jax(variant):
    jm, variables, tm = _pair(variant=variant)
    batch = _batch(1)
    je, js = jm.apply(variables, batch, train=False)
    tm.eval()
    with torch.no_grad():
        te, ts = tm(_tb(batch))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_model_train_mode_matches_jax_with_bn_stats():
    """Train-mode forward: batch statistics normalize, and the running stats
    update with the unbiased variance (torch semantics on both sides)."""
    jm, variables, tm = _pair(seed=2)
    batch = _batch(3)
    (je, js), upd = jm.apply(variables, batch, train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        te, ts = tm(_tb(batch))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    want = params_from_jax(variables["params"], jax.device_get(upd["batch_stats"]), tm.config)
    got = tm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 11  # every BatchNorm of tiny_densenet
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)


def test_attention_key_mask_matches_jax(rng):
    x = rng.normal(size=(2, 6, 24)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 0]], bool)
    jmod = jax_layers.MultiHeadSelfAttention(24, heads=2, dim_head=16)
    p = jax.device_get(jmod.init(jax.random.PRNGKey(0), x, mask=mask))["params"]
    want = jmod.apply({"params": p}, x, mask=mask)
    tmod = layers.MultiHeadSelfAttention(24, heads=2, dim_head=16)
    with torch.no_grad():
        tmod.to_qkv.weight.copy_(torch.from_numpy(np.array(p["to_qkv"]["kernel"].T)))
        tmod.to_out[0].weight.copy_(torch.from_numpy(np.array(p["to_out"]["kernel"].T)))
        tmod.to_out[0].bias.copy_(torch.from_numpy(np.array(p["to_out"]["bias"])))
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_symmetric_infonce_matches_jax(rng):
    s = rng.normal(size=(8, 32)).astype(np.float32)
    i = rng.normal(size=(8, 32)).astype(np.float32)
    for t in (1.0, 0.5):
        want = float(jax_infonce(jnp.asarray(s), jnp.asarray(i), t))
        got = float(symmetric_infonce(torch.from_numpy(s), torch.from_numpy(i), t))
        np.testing.assert_allclose(got, want, **TOL)


def test_params_from_jax_equals_reference_export():
    """The bridge writes the same dict as the JAX build's reference exporter
    (positional tables unpadded), for densenet121 at a small spot_dim; the
    port's densenet121 MclSTExp takes it with strict=True."""
    kw = dict(encoder_name="densenet121", image_dim=1024, spot_dim=16, projection_dim=32,
              heads_num=4, heads_dim=8, head_layers=2, pos_vocab=128)
    jm = JaxMclSTExp(jax_config.ModelConfig(**kw))
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), _batch(0, n=2, patch=32, genes=16,
                                                            vocab=128), train=False))
    want = export_reference_state_dict(v["params"], v["batch_stats"], jm.config, pos_rows=128)
    cfg = config.ModelConfig(**kw)
    got = params_from_jax(v["params"], v["batch_stats"], cfg)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    MclSTExp(cfg, device="meta").load_state_dict(got, strict=True, assign=True)


def test_params_from_jax_rejects_unconsumed_leaves():
    _, variables, tm = _pair()
    params = dict(variables["params"], stray={"leaf": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unconverted"):
        params_from_jax(params, variables["batch_stats"], tm.config)


def test_presets_match_jax():
    assert set(config.PRESETS) == set(jax_config.PRESETS)
    for name, preset in config.PRESETS.items():
        for part in ("model", "train", "eval", "data"):
            ours = dataclasses.asdict(getattr(preset, part))
            theirs = dataclasses.asdict(getattr(jax_config.PRESETS[name], part))
            assert ours == theirs, (name, part)


def test_model_rejects_unported_options():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        MclSTExp(config.ModelConfig(**{**TINY, "dtype": "float16"}), device="cpu")
    with pytest.raises(KeyError, match="unknown image encoder"):
        MclSTExp(config.ModelConfig(**{**TINY, "encoder_name": "nope"}), device="cpu")



def test_model_builds_in_bfloat16():
    """dtype "bfloat16": fp32 parameters and running statistics, every
    computing module of both towers and heads in bf16, fp32 embeddings."""
    model = MclSTExp(config.ModelConfig(**{**TINY, "dtype": "bfloat16"}), device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in model.buffers())
    computing = [m for m in model.modules() if hasattr(type(m), "compute_dtype")]
    assert computing and all(m.compute_dtype == torch.bfloat16 for m in computing)
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand((4, 32, 32, 3), generator=g),
             "expression": torch.rand((4, 24), generator=g),
             "position": torch.randint(0, 64, (4, 2), generator=g)}
    image_emb, spot_emb = model.eval()(batch)
    assert image_emb.dtype == spot_emb.dtype == torch.float32
    assert image_emb.shape == spot_emb.shape == (4, 32)
