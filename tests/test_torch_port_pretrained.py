"""Pretrained towers and the ViT key layout against the JAX package, on the CPU.

* a torchvision-layout pretrained tower (``--pretrained``; densenet121's
  ``features.*`` and resnet50's ``conv1/bn1/layer*``, each with the
  classifier head the import drops), written here from a seeded init, grafts
  into the port's model as the JAX ``import_image_tower`` (the heart of
  ``load_pretrained_tower``) reads it;
* the ViT key layout (timm names) against the JAX exporter's on a narrow
  ViT, and a full-size CLIP ViT model through export and import.
All comparisons are exact.
"""

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu.models.image import torch_export as jax_export
from mclstexp_tpu.models.image import torch_import as jax_import
from mclstexp_tpu.models.image import vit as jax_vit
from mclstexp_tpu.train.checkpoint import load_torch_state_dict as jax_load
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.core.layers import init_parameters
from mclstexp_tpu_torch.interop import tower_params_from_jax
from mclstexp_tpu_torch.models.image import torch_export, torch_import
from mclstexp_tpu_torch.models.image.registry import build_encoder
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.train.state import TrainState, create_train_state
from test_torch_port_export import SMALL

torch.set_num_threads(1)


def _torchvision_layout(name, tower_sd):
    """The port tower's state_dict in torchvision's own layout, with the
    classifier head that the import drops."""
    out = {}
    for k, v in tower_sd.items():
        rest = k[len("model."):]
        if name == "densenet121":
            out["features." + rest[len("0."):]] = v
        else:
            head, _, tail = rest.partition(".")
            new = {"0": "conv1", "1": "bn1"}.get(head) or f"layer{int(head) - 3}"
            out[f"{new}.{tail}"] = v
    g = torch.Generator().manual_seed(9)
    head = "classifier" if name == "densenet121" else "fc"
    width = 1024 if name == "densenet121" else 2048
    out[f"{head}.weight"] = torch.randn(1000, width, generator=g)
    out[f"{head}.bias"] = torch.randn(1000, generator=g)
    return out


@pytest.mark.parametrize("name,dim", [("densenet121", 1024), ("resnet50", 2048)])
def test_pretrained_tower_grafts_as_in_jax(name, dim, tmp_path):
    tower = build_encoder(name)[0]
    init_parameters(tower, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    for k, v in tower.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
        elif k.endswith("num_batches_tracked"):
            v.fill_(0)
    pt = str(tmp_path / f"{name}.pt")
    torch.save(_torchvision_layout(name, tower.state_dict()), pt)

    kw = {**SMALL, "encoder_name": name, "image_dim": dim}
    cfg = config.ModelConfig(**kw, pretrained_path=pt)
    state = create_train_state(cfg, config.TrainConfig(), device="cpu")
    grafted = state.model.tower.state_dict()
    for k, v in tower.state_dict().items():
        assert torch.equal(grafted[k], v), k

    jparams, jstats = jax_import.import_image_tower(jax_load(pt), name)
    want = tower_params_from_jax(jparams, jstats, name)
    assert want.keys() == grafted.keys()
    for k, v in want.items():
        assert torch.equal(grafted[k], v), k
    # the spot side keeps its random init
    assert not torch.equal(state.model.spot_projection.fc.weight,
                           torch.zeros_like(state.model.spot_projection.fc.weight))


def test_vit_keys_are_the_jax_exporters(tmp_path):
    for pre_norm in (False, True):
        x = np.zeros((1, 224, 224, 3), np.float32)
        jm = jax_vit.ViTEncoder(dim=64, depth=2, heads=2, mlp_dim=128, pre_norm=pre_norm)
        params = jax.device_get(jm.init(jax.random.PRNGKey(5), x))["params"]
        e = jax_export._Exporter({"image_encoder": params}, {})
        jax_export._export_vit(e, "", "image_encoder")
        port = tower_params_from_jax(params, {}, "vit")
        timm = {torch_import.vit_key_to_timm(k[len("model."):], pre_norm): v
                for k, v in port.items()}
        assert timm.keys() == e.out.keys()
        for k, v in e.out.items():
            assert torch.equal(timm[k], torch.from_numpy(np.ascontiguousarray(v))), k
        assert {"model." + torch_import.vit_key_from_timm(k) for k in timm} == port.keys()
        assert ("norm.weight" in timm) == pre_norm and ("fc_norm.weight" in timm) != pre_norm


def test_full_size_vit_model_exports_and_imports(tmp_path):
    cfg = config.ModelConfig(encoder_name="clip_vit", image_dim=768, **SMALL)
    model = MclSTExp(cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(6))
    sd = model.state_dict()
    path = torch_export.save_reference_checkpoint(str(tmp_path / "vit.pt"), sd, cfg)
    ref = torch.load(path, weights_only=True)
    assert {"image_encoder.model.norm_pre.weight", "image_encoder.model.norm.bias",
            "image_encoder.model.patch_embed.proj.weight",
            "image_encoder.model.blocks.11.mlp.fc2.weight"} <= set(ref)
    assert ref["image_encoder.model.pos_embed"].shape == (1, 50, 768)
    back = MclSTExp(cfg, device="cpu")
    torch_import.load_into_state(TrainState(back, None), path, cfg)
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
