"""The image towers of the port against the JAX package's, on the CPU.

Each tower gets the JAX tower's weights through
``interop.tower_params_from_jax`` and the same NHWC input made from a seed
with numpy. Tolerances: ``TinyCNN`` 1e-5 absolute (its outputs are O(1));
the resnets and the ViT 1e-4 of each output's largest magnitude (fp32
convolutions and matmuls summed in another order; the resnets' batch
statistics in train mode). The odd 33 px input pins flax's SAME padding,
which pads (1, 1) there and (0, 1) on an even size.
"""

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.models.image import registry as jax_registry
from mclstexp_tpu.models.image import resnet as jax_resnet
from mclstexp_tpu.models.image import vit as jax_vit
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.core.layers import init_parameters
from mclstexp_tpu_torch.interop import tower_params_from_jax
from mclstexp_tpu_torch.models.image import registry, resnet, vit

torch.set_num_threads(1)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, size, size, 3)).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("size", [16, 32, 33])
def test_tiny_cnn_matches_jax(size):
    x = _images(3, size)
    jm = jax_vit.TinyCNN()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1), x))
    want = np.asarray(jm.apply(variables, x))
    tm = vit.TinyCNN()
    tm.load_state_dict(tower_params_from_jax(variables["params"], {}, "tiny_cnn"), strict=True)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["res18", "resnet50"])
def test_resnets_match_jax_in_train_and_eval_mode(name):
    """One train-mode pass (output and running statistics), then eval mode
    on the statistics it left. Batch 8: at 64 px layer4's batch norm reduces
    over n x 2 x 2 values, and at n = 4 both fp32 towers sit ~1.7e-4 (of the
    largest output) from a float64 evaluation of the port."""
    x = _images(8, 64, seed=2)
    factory = {"res18": jax_resnet.resnet18, "resnet50": jax_resnet.resnet50}[name]
    jm = factory()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(2), x, train=False))
    tm = registry.build_encoder(name)[0]
    tm.load_state_dict(tower_params_from_jax(variables["params"], variables["batch_stats"],
                                             name), strict=True)

    tm.train()
    got = tm(torch.from_numpy(x)).detach().numpy()
    want, updates = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    _close(got, want, 1e-4)
    updated = dict(variables, batch_stats=jax.device_get(updates["batch_stats"]))
    stats = tower_params_from_jax(updated["params"], updated["batch_stats"], name)
    now = tm.state_dict()
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in tm.modules())
    for k in keys:
        _close(now[k].numpy(), stats[k].numpy(), 1e-4)

    tm.load_state_dict(stats, strict=True)
    tm.eval()
    want = np.asarray(jm.apply(updated, x, train=False))
    assert np.count_nonzero(want) > want.size // 2
    _close(tm(torch.from_numpy(x)).detach().numpy(), want, 1e-4)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_narrow_vit_matches_jax(pre_norm):
    x = _images(2, 224, seed=3)
    kw = dict(dim=64, depth=2, heads=2, mlp_dim=128, pre_norm=pre_norm)
    jm = jax_vit.ViTEncoder(**kw)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), x))
    params = jax.tree.map(np.array, variables["params"])
    params["cls_token"] += 0.5  # zeros at init: give the CLS token a value to carry
    tm = vit.ViTEncoder(**kw)
    tm.load_state_dict(tower_params_from_jax(params, {}, "vit"), strict=True)
    got = tm(torch.from_numpy(x)).detach().numpy()
    want = jm.apply({"params": params}, x)
    assert got.shape == (2, 64)
    _close(got, want, 1e-4)


def test_registry_and_dims_match_jax():
    assert config.ENCODER_DIMS == jax_config.ENCODER_DIMS
    assert {k: d for k, (_, d) in registry.ENCODERS.items()} == {
        k: d for k, (_, d) in jax_registry.ENCODERS.items()}
    assert registry.ENCODERS.keys() == config.ENCODER_DIMS.keys()
    with pytest.raises(KeyError, match="unknown image encoder"):
        registry.build_encoder("nope")


@pytest.mark.parametrize("name", ["tiny_cnn", "res18", "vit"])
def test_towers_emit_their_registered_dims_from_a_seeded_init(name):
    tower, dim = registry.build_encoder(name)
    init_parameters(tower, torch.Generator().manual_seed(0))
    size = 224 if name == "vit" else 32
    out = tower.eval()(torch.from_numpy(_images(2, size)))
    assert out.shape == (2, dim) and torch.isfinite(out).all()
    again, _ = registry.build_encoder(name)
    init_parameters(again, torch.Generator().manual_seed(0))
    for (k, a), b in zip(tower.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    if name == "vit":
        assert torch.count_nonzero(tower.model.cls_token) == 0
        assert 0.015 < float(tower.model.pos_embed.detach().std()) < 0.025


def test_resnet_keys_are_torchvision_layout():
    keys = resnet.resnet50().state_dict().keys()
    assert {"model.0.weight", "model.1.running_var", "model.4.0.conv3.weight",
            "model.4.0.downsample.0.weight", "model.7.2.bn3.bias"} <= set(keys)
    assert "model.4.1.downsample.0.weight" not in keys
