"""Reference ``.pt`` interop of the port against the JAX package, on the CPU.

* the port's export (``models/image/torch_export.py``) of weights carried
  over by ``interop`` equals the JAX export of the same trees key for key
  and bit for bit, with the position tables padded to 65,536 rows and
  scattered through a ``PosRemap``; the JAX importer reads the port's
  ``.pt`` back to the JAX trees, and the port's importer to its own model;
* the reference's key shims (``module.``, ``well``) read as in the JAX
  package;
* what has no reference layout, or does not fit, raises.
The pretrained towers and the ViT layout: ``test_torch_port_pretrained.py``.
All comparisons are exact: the conversions move bits, they compute nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.data.posremap import PosRemap as JaxPosRemap
from mclstexp_tpu.models.image import torch_export as jax_export
from mclstexp_tpu.models.image import torch_import as jax_import
from mclstexp_tpu.models.mclstexp import MclSTExp as JaxMclSTExp
from mclstexp_tpu.train import checkpoint as jax_ckpt
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.data.posremap import PosRemap
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.image import torch_export, torch_import
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.train import checkpoint
from mclstexp_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

SMALL = dict(spot_dim=16, projection_dim=32, heads_num=4, heads_dim=8, head_layers=2,
             pos_vocab=128)


def _jax_variables(cfg_kw, patch=32):
    s = jax_synthetic.make_dataset(num_genes=cfg_kw["spot_dim"], patch_size=patch)[0]
    sample = {"image": s.patches[:2].astype(np.float32) / 255.0,
              "expression": s.expression[:2], "position": s.positions[:2]}
    jcfg = jax_config.ModelConfig(**cfg_kw)
    model = JaxMclSTExp(jcfg)
    # jitted: flax's eager init of densenet121 takes twice the compile
    v = jax.device_get(jax.jit(lambda key, batch: model.init(key, batch, train=False))(
        jax.random.PRNGKey(0), sample))
    # running statistics off their (0, 1) init, so that a dropped one shows
    stats = jax.tree.map(lambda a: a + np.float32(0.25), v.get("batch_stats", {}))
    return jcfg, v["params"], stats


def _port_sd(cfg_kw, params, stats):
    cfg = config.ModelConfig(**cfg_kw)
    return cfg, params_from_jax(params, stats, cfg)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = np.asarray(v)
    return out


def _same_trees(got, want, remap=None):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        other = want[path]
        if remap is not None and path[-1] in ("x_embed", "y_embed"):
            n = len(remap.x_values if path[-1] == "x_embed" else remap.y_values)
            leaf, other = leaf[:n], other[:n]
        assert np.array_equal(leaf, other), path


@pytest.fixture(scope="module", params=[
    dict(encoder_name="densenet121", image_dim=1024),
    dict(encoder_name="res18", image_dim=512),
    dict(encoder_name="res18", image_dim=512, variant="mlp"),
], ids=["densenet121", "res18", "res18-mlp"])
def shared(request):
    kw = {**SMALL, **request.param}
    jcfg, params, stats = _jax_variables(kw)
    cfg, sd = _port_sd(kw, params, stats)
    return kw, jcfg, params, stats, cfg, sd


@pytest.mark.parametrize("remapped", [False, True], ids=["pos_rows", "posremap"])
def test_export_equals_jax_export_and_reads_back(shared, remapped, tmp_path):
    kw, jcfg, params, stats, cfg, sd = shared
    remap = jremap = None
    if remapped:
        remap = PosRemap.build(synthetic.make_dataset(num_genes=16, patch_size=32))
        jremap = JaxPosRemap.build(jax_synthetic.make_dataset(num_genes=16, patch_size=32))
        assert remap.vocab == jremap.vocab == cfg.pos_vocab
    got = torch_export.export_reference_state_dict(sd, cfg, pos_rows=65536, pos_remap=remap)
    want = jax_export.export_reference_state_dict(params, stats, jcfg, pos_rows=65536,
                                                  pos_remap=jremap)
    assert list(got) == list(got.keys()) and got.keys() == want.keys()
    for k, w in want.items():
        w = torch.from_numpy(np.array(w))
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
    if cfg.variant == "mlp":
        assert any(k.startswith("image_ecode.") for k in got)

    path = torch_export.save_reference_checkpoint(str(tmp_path / "ref.pt"), sd, cfg,
                                                  pos_remap=remap)
    jsd = jax_ckpt.load_torch_state_dict(path)
    if cfg.variant == "mlp":  # the JAX importer reads the attention variant's name
        jsd = {k.replace("image_ecode.", "image_encoder."): v for k, v in jsd.items()}
    back_params, back_stats = jax_import.import_reference_state_dict(jsd, jcfg,
                                                                     pos_remap=jremap)
    _same_trees(back_params, params, jremap)
    _same_trees(back_stats, stats)

    # the port reads its own file and the JAX exporter's (num_batches_tracked
    # as (1,) there) back to the weights it exported
    jpath = jax_export.save_reference_checkpoint(str(tmp_path / "jax.pt"), params, stats, jcfg,
                                                 pos_remap=jremap)
    for pt in (path, jpath):
        model = MclSTExp(cfg, device="cpu")
        state = torch_import.load_into_state(TrainState(model, None), pt, cfg, pos_remap=remap)
        assert state.model is model
        for k, v in model.state_dict().items():
            want = sd[k]
            if remapped and k in ("x_embed.weight", "y_embed.weight"):
                n = len(remap.x_values if k[0] == "x" else remap.y_values)
                v, want = v[:n], want[:n]
            assert torch.equal(v, want), k


def test_reference_key_shims(shared, tmp_path):
    kw, jcfg, params, stats, cfg, sd = shared
    exported = torch_export.export_reference_state_dict(sd, cfg)
    shimmed = {"module." + k.replace("spot", "well"): v for k, v in exported.items()}
    assert any("well_encoder" in k for k in shimmed) or cfg.variant == "mlp"
    torch.save(shimmed, tmp_path / "dp.pt")
    got = checkpoint.load_torch_state_dict(str(tmp_path / "dp.pt"))
    assert got.keys() == exported.keys()
    assert got.keys() == jax_ckpt.load_torch_state_dict(str(tmp_path / "dp.pt")).keys()
    model = MclSTExp(cfg, device="cpu")
    torch_import.load_into_state(TrainState(model, None), str(tmp_path / "dp.pt"), cfg)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_mismatches_raise(shared, tmp_path):
    kw, jcfg, params, stats, cfg, sd = shared
    exported = torch_export.export_reference_state_dict(sd, cfg)
    with pytest.raises(ValueError, match="unconsumed torch tensors \\['extra'\\]"):
        torch_import.import_reference_state_dict({**exported, "extra": torch.zeros(1)}, cfg)
    dropped = {k: v for k, v in exported.items() if not k.startswith("image_projection.fc")}
    with pytest.raises(ValueError, match="missing .*image_projection.fc.weight"):
        torch_import.import_reference_state_dict(dropped, cfg)
    wider = dataclasses.replace(cfg, spot_dim=cfg.spot_dim + 1)
    with pytest.raises(ValueError, match="shape mismatches"):
        torch_import.import_reference_state_dict(exported, wider)
    for name in ("tiny_cnn", "tiny_densenet"):
        tiny = dataclasses.replace(cfg, encoder_name=name, image_dim=config.ENCODER_DIMS[name])
        with pytest.raises(NotImplementedError, match="no reference torch layout"):
            torch_export.export_reference_state_dict(
                MclSTExp(tiny, device="cpu").state_dict(), tiny)
        with pytest.raises(NotImplementedError):
            jax_export.export_reference_state_dict(params, stats,
                                                   dataclasses.replace(jcfg, encoder_name=name))
