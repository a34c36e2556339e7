"""Reference-trained baseline checkpoints into the port and into the JAX
package.

For each family, one set of reference-layout tensors (the port's modules at
the small widths of the family's parity tests, every tensor drawn from a
seed: weights, batch-norm running statistics, and for Hist2ST a nonzero LSTM
``bias_hh``, which JAX sums into its one bias and the port keeps; BLEEP's
res18 tower in timm's names, ``conv1/bn1/layer1..4``) is written three
ways: a plain ``state_dict`` ``.pt``, a ``module.``-prefixed ``.pt`` and a
Lightning ``.ckpt`` (``model.`` keys beside non-tensor metadata that
``weights_only`` refuses). Each is loaded by the port's
``load_baseline_torch_checkpoint`` and by JAX's: the port holds the tensors
exactly, and ``predict_slide`` (BLEEP: ``bleep_embeddings``) agrees with
JAX's within the forward tolerances of the families' parity tests (atol
1e-4). One tensor too many, or one too few, raises in both packages. The
BLEEP tower map is checked for every ``--bleep-encoder`` the CLI offers.
"""

import argparse

import numpy as np
import pytest
import torch
import test_torch_port_baselines as tb
import test_torch_port_bleep as tbl
import test_torch_port_hist2st as th

from mclstexp_tpu.baselines import models as jax_models
from mclstexp_tpu.baselines import torch_import as jax_import
from mclstexp_tpu.baselines import trainer as jax_trainer
from mclstexp_tpu.train.state import TrainState as JaxTrainState
from mclstexp_tpu_torch.baselines import models, trainer
from mclstexp_tpu_torch.baselines import torch_import
from mclstexp_tpu_torch.models.image.torch_import import vit_key_to_timm

torch.set_num_threads(1)

FAMILIES = ("histogene", "hist2st", "thitogene", "bleep")
LAYOUTS = ("plain", "module", "lightning")
_TIMM_RESNET = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
                "7": "layer4"}


def _case(family):
    """(JAX model, a port model factory, port config kwargs, JAX sections,
    port sections)."""
    if family == "hist2st":
        jmodel, _ = th._models(coef_head=True)
        jsecs, tsecs = th._sections([21, 13], seed=2)
        return jmodel, lambda: th._models(coef_head=True)[1], th._cfg(), jsecs, tsecs
    if family == "bleep":
        jmodel, _ = tbl._models("res18")
        jsecs, tsecs = tbl._sections(n=12, num=2)
        return jmodel, lambda: tbl._models("res18")[1], dict(tbl._cfg(), encoder_name="res18"), \
            jsecs, tsecs
    jmodel, _, patch = tb._small(family)
    jsecs, tsecs = tb._sections([21, 13], patch, seed=2)
    return jmodel, lambda: tb._small(family)[1], tb._cfg(family, patch), jsecs, tsecs


def _timm_name(key):
    """A port BLEEP key -> the reference's (timm resnet) name."""
    if not key.startswith(torch_import.BLEEP_TOWER):
        return key
    head, _, rest = key[len(torch_import.BLEEP_TOWER):].partition(".")
    return f"{torch_import.BLEEP_TOWER}{_TIMM_RESNET.get(head, head)}.{rest}"


def _reference_tensors(family, model):
    """A reference-layout state_dict of ``model``'s shapes, every tensor
    drawn from a seed."""
    g = torch.Generator().manual_seed(7)
    models.init_baseline_parameters(model, g)
    sd = {}
    for key, value in model.state_dict().items():
        value = value.clone()
        if key.endswith("running_mean") or key.endswith(".bias_hh_l0") or \
                key.endswith(".bias_hh_l1"):
            value = 0.1 * torch.randn(value.shape, generator=g)
        elif key.endswith("running_var"):
            value = 0.5 + torch.rand(value.shape, generator=g)
        elif key.endswith("num_batches_tracked"):
            value = torch.tensor(5)
        sd[_timm_name(key) if family == "bleep" else key] = value
    if family == "hist2st":
        assert all(sd[f"vit.transformer.jknet.0.bias_hh_l{i}"].abs().min() > 0 for i in (0, 1))
    return sd


def _write(path, sd, layout):
    if layout == "plain":
        torch.save(sd, path)
    elif layout == "module":
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    else:
        torch.save({"epoch": 3, "global_step": 12, "pytorch-lightning_version": "1.9.0",
                    "hyper_parameters": argparse.Namespace(learning_rate=1e-5, n_layers=1),
                    "state_dict": {f"model.{k}": v for k, v in sd.items()}}, path)
    if layout == "lightning":  # its metadata needs the fallback to weights_only=False
        with pytest.raises(Exception):
            torch.load(path, weights_only=True)


def _outputs(family, jmodel, jstate, tmodel, cfg_kw, jsecs, tsecs):
    """(port, JAX) predictions of every section (BLEEP: the image and spot
    embeddings of all sections)."""
    if family == "bleep":
        got = trainer.bleep_embeddings(tmodel, tsecs)
        want = jax_trainer.bleep_embeddings(jmodel, jstate, jsecs)
        return list(got), [np.asarray(w) for w in want]
    jcfg, tcfg = jax_trainer.BaselineConfig(**cfg_kw), trainer.BaselineConfig(**cfg_kw)
    return ([trainer.predict_slide(tmodel, s, tcfg) for s in tsecs],
            [np.asarray(jax_trainer.predict_slide(jmodel, jstate, s, jcfg)) for s in jsecs])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_reference_checkpoint_loads_as_in_jax(family, layout, tmp_path):
    jmodel, make_port, cfg_kw, jsecs, tsecs = _case(family)
    sd = _reference_tensors(family, make_port())
    path = str(tmp_path / ("ref.ckpt" if layout == "lightning" else "ref.pt"))
    _write(path, sd, layout)

    tmodel = make_port()
    assert torch_import.load_baseline_torch_checkpoint(path, family, tmodel) is tmodel
    loaded = {(_timm_name(k) if family == "bleep" else k): v
              for k, v in tmodel.state_dict().items()}
    assert loaded.keys() == sd.keys()
    for key, want in sd.items():
        assert torch.equal(loaded[key], want), key

    params, stats = jax_import.load_baseline_torch_checkpoint(path, family, jmodel)
    jstate = JaxTrainState(step=0, params=params, batch_stats=stats, opt_state=None, tx=None)
    got, want = _outputs(family, jmodel, jstate, tmodel, cfg_kw, jsecs, tsecs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **tb.FWD_TOL)


@pytest.mark.parametrize("fault", ["extra", "missing"])
@pytest.mark.parametrize("family", FAMILIES)
def test_an_extra_or_missing_tensor_raises_in_both(family, fault, tmp_path):
    jmodel, make_port, _, _, _ = _case(family)
    sd = _reference_tensors(family, make_port())
    if fault == "extra":
        key = f"{torch_import.BLEEP_TOWER}layer9.0.conv1.weight" if family == "bleep" \
            else "gene_head.9.bias"
        sd[key] = torch.zeros(3)
    else:
        sd.pop(next(k for k in sd if k.endswith("weight")))
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        torch_import.load_baseline_torch_checkpoint(path, family, make_port())
    with pytest.raises((KeyError, ValueError)):
        jax_import.load_baseline_torch_checkpoint(path, family, jmodel)


@pytest.mark.parametrize("encoder", ["resnet50", "res101", "resnet152", "vit", "vit_l",
                                     "clip_vit", "tiny_cnn"])
def test_bleep_tower_map_for_every_cli_encoder(encoder):
    """The port's BLEEP keys, written in the reference's timm names (resnets:
    ``conv1/bn1/layer1..4``; ViTs: ``norm1/attn.qkv/…``, ``fc_norm`` or the
    CLIP trunk's ``norm``) or as the port writes them, map back to the port's
    keys and shapes; ``tiny_cnn`` has no reference layout and raises, as in
    JAX."""
    model = models.BLEEP(16, encoder, device="meta")
    port = model.state_dict()
    if encoder == "tiny_cnn":
        with pytest.raises(NotImplementedError):
            torch_import.bleep_state_dict(port, encoder)
        with pytest.raises(NotImplementedError):
            jax_import.import_bleep_state_dict({k: np.zeros(1) for k in port},
                                               jax_models.BLEEP(spot_dim=16,
                                                                encoder_name=encoder))
        return
    pre_norm = any(".norm_pre." in k for k in port)
    tower = torch_import.BLEEP_TOWER
    if encoder.startswith("vit") or encoder == "clip_vit":
        ref = {(tower + vit_key_to_timm(k[len(tower):], pre_norm) if k.startswith(tower)
                else k): v for k, v in port.items()}
    else:
        ref = {_timm_name(k): v for k, v in port.items()}
    assert ref.keys() != port.keys()
    for sd in (ref, port):
        mapped = torch_import.bleep_state_dict(sd, encoder)
        assert set(mapped) == set(port)
        assert all(mapped[k].shape == port[k].shape for k in port)
