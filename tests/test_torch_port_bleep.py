"""BLEEP in the port against the JAX package.

Both packages get the same numpy inputs; the port's weights come from the
JAX variables through ``interop.baseline_params_from_jax``. Towers:
``tiny_cnn`` (32-px patches) for the step, the fold and the retrieval, and
``res18`` where batch norms and the reference key layout matter (its
forward in train mode, the state dict back into the JAX importer); 16
genes, projection 256, dropout 0 where trajectories are compared.

Tolerances: the CLIP loss rtol 1e-5 (its gradients within 1e-5 of their
largest magnitude); forwards atol 1e-5 (tiny_cnn) and 1e-4 (res18, deeper
sums), res18's running statistics rtol 1e-4; three AdamW steps, each from
the JAX trajectory's state: losses rtol 1e-4, gradients within 1e-4 of each
tensor's largest magnitude, updates within 0.05 lr; embeddings atol 1e-5;
``evaluate_fold``'s metrics rtol 1e-4; batch order exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_baselines import _assert_step_matches, _sync_from_jax

from mclstexp_tpu.baselines import losses as jax_losses
from mclstexp_tpu.baselines import models as jax_models
from mclstexp_tpu.baselines import torch_import as jax_import
from mclstexp_tpu.baselines import trainer as jax_trainer
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.infer import embed as jax_embed
from mclstexp_tpu.infer import evaluate as jax_evaluate
from mclstexp_tpu.train.state import TrainState as JaxTrainState
from mclstexp_tpu_torch import interop
from mclstexp_tpu_torch.baselines import losses, models, trainer
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.infer import embed, evaluate
from mclstexp_tpu_torch.train.state import TrainState
from mclstexp_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

G, PATCH = 16, 32


def _models(encoder="tiny_cnn", dropout=0.0):
    return (jax_models.BLEEP(spot_dim=G, encoder_name=encoder, dropout=dropout),
            models.BLEEP(G, encoder, dropout=dropout, device="cpu"))


def _sections(n=30, num=3, seed=0):
    """The same synthetic sections in both packages."""
    return (jax_synthetic.make_dataset(num, n, G, PATCH, seed=seed),
            synthetic.make_dataset(num, n, G, PATCH, seed=seed))


def _cfg(**kw):
    return dict(model="bleep", n_genes=G, encoder_name="tiny_cnn", **kw)


def _batch(section, idx):
    return {"image_u8": np.asarray(section.patches)[idx], "expression": section.expression[idx]}


def _variables(jmodel, section):
    images = np.asarray(section.patches)[:2].astype(np.float32) / 255.0
    return jax.device_get(jmodel.init(jax.random.PRNGKey(0), {
        "image": images, "expression": section.expression[:2]}))


def _carried(tmodel, variables):
    tmodel.load_state_dict(interop.baseline_params_from_jax(
        tmodel, variables["params"], variables.get("batch_stats", {})), strict=True)
    return tmodel


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_clip_loss_matches_jax(temperature):
    """bleep_clip_loss (soft targets from the intra-modal similarities) and
    its gradients against the JAX function."""
    r = np.random.default_rng(1)
    spot, img = (r.normal(size=(12, 8)).astype(np.float32) for _ in range(2))
    want, want_grads = jax.value_and_grad(
        lambda s, i: jax_losses.bleep_clip_loss(s, i, temperature), argnums=(0, 1))(spot, img)
    ts, ti = (torch.from_numpy(a).requires_grad_() for a in (spot, img))
    got = losses.bleep_clip_loss(ts, ti, temperature)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for t, w in zip((ts, ti), want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("encoder", ["tiny_cnn", "res18"])
def test_forward_matches_jax(encoder, train):
    """The two fp32 embeddings of a batch; res18 in train mode also its new
    running statistics."""
    jmodel, tmodel = _models(encoder)
    jsecs, _ = _sections(n=12, num=1)
    variables = _variables(jmodel, jsecs[0])
    _carried(tmodel, variables)
    batch = _batch(jsecs[0], np.arange(10))
    inputs = {"image": batch["image_u8"].astype(np.float32) / np.float32(255),
              "expression": batch["expression"]}
    out = jmodel.apply(variables, inputs, train=train,
                       mutable=["batch_stats"] if train else False)
    want, updates = out if train else (out, None)
    tmodel.train(train)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in inputs.items()})
    tol = 1e-5 if encoder == "tiny_cnn" else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (10, 256)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
    if train and encoder == "res18":
        sd = interop.baseline_params_from_jax(tmodel, variables["params"],
                                              jax.device_get(updates["batch_stats"]))
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * 20  # the stem, 8 blocks of 2, 3 downsamples
        for key in stats:
            np.testing.assert_allclose(tmodel.state_dict()[key].numpy(), sd[key].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key)


def test_three_adamw_steps_match_jax():
    """make_bleep_step at dropout 0 on three batches (the uint8 images scaled
    as the jitted JAX step scales them), each step from the JAX trajectory's
    state (weights, AdamW moments): the loss, the gradients against
    ``jax.grad`` of the JAX step's loss, and each element's update against
    ``make_bleep_step``'s AdamW step (decoupled decay 1e-3)."""
    lr = 1e-3
    jcfg, tcfg = (mod.BaselineConfig(**_cfg(lr=lr)) for mod in (jax_trainer, trainer))
    jmodel, tmodel = _models()
    jsecs, tsecs = _sections()
    variables = _variables(jmodel, jsecs[0])
    tx = jax_trainer.baseline_optimizer(jcfg)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats={}, opt_state=tx.init(variables["params"]), tx=tx)
    optimizer = trainer.baseline_optimizer(tcfg, tmodel.parameters())
    assert isinstance(optimizer, torch.optim.AdamW)
    state = TrainState(_carried(tmodel, variables), optimizer)
    jstep, step = jax_trainer.make_bleep_step(jmodel, jcfg), trainer.make_bleep_step(tcfg)

    def jax_loss(params, batch):
        images = batch["image_u8"].astype(jnp.float32) / 255.0
        ie, se = jmodel.apply({"params": params}, {"image": images,
                                                   "expression": batch["expression"]}, train=True)
        return jax_losses.bleep_clip_loss(se, ie, jcfg.temperature)

    jgrad = jax.jit(jax.grad(jax_loss))
    r = np.random.default_rng(5)
    for i in range(3):
        if i:
            _sync_from_jax(state, jstate)
        b = _batch(jsecs[i], r.permutation(30)[:24])
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        want_grads = interop.baseline_params_from_jax(tmodel, jax.device_get(
            jgrad(jstate.params, jbatch)), {})
        jstate, jloss = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        before = {k: v.clone() for k, v in tmodel.state_dict().items()}
        loss = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                    torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        want_after = interop.baseline_params_from_jax(tmodel, jax.device_get(jstate.params), {})
        grads = {name: p.grad for name, p in tmodel.named_parameters()}
        _assert_step_matches(tmodel, before, grads, want_grads, want_after, lr, i, near_zero=())
    assert state.step == 3


def test_train_bleep_fold_takes_the_jax_batches(monkeypatch):
    """train_bleep_fold's batches, epoch by epoch, are the JAX fold's (the
    shared pipeline's shuffle over the training sections, remainder kept),
    and its real fold on the CPU logs a finite loss per epoch."""
    jsecs, tsecs = _sections(n=20)
    kw = _cfg(batch_size=16, max_epochs=2, seed=3)
    seen_jax, seen = [], []

    def jax_fake(model, cfg):
        def step(state, batch, rng):
            seen_jax.append(np.asarray(batch["expression"]))
            return state, jnp.float32(0.0)
        return step

    def fake(cfg):
        def step(state, batch, generator, shard=None):
            assert shard is None  # no mesh
            seen.append(batch["expression"].numpy())
            return torch.zeros(())
        return step

    monkeypatch.setattr(jax_trainer, "make_bleep_step", jax_fake)
    monkeypatch.setattr(trainer, "make_bleep_step", fake)
    jax_trainer.train_bleep_fold(jax_trainer.BaselineConfig(**kw), jsecs, 1)
    trainer.train_bleep_fold(trainer.BaselineConfig(**kw), tsecs, 1, device="cpu")
    assert [len(b) for b in seen] == [16, 16, 8] * 2
    for got, want in zip(seen, seen_jax):
        np.testing.assert_array_equal(got, want)
    monkeypatch.undo()
    logger = MetricLogger(echo=False)
    state = trainer.train_bleep_fold(trainer.BaselineConfig(**kw), tsecs, 1, logger=logger,
                                     device="cpu")
    assert state.step == 6 and isinstance(state.model, models.BLEEP)
    assert [rec["epoch"] for rec in logger.records] == [0, 1]
    assert all(np.isfinite(rec["loss"]) for rec in logger.records)


@pytest.fixture(scope="module")
def embeddings_case():
    """Both packages' bleep_embeddings of three sections from the same
    weights (dropout 0.1, off in eval mode), and the sections."""
    jmodel, tmodel = _models(dropout=0.1)
    jsecs, tsecs = _sections(seed=4)
    variables = _variables(jmodel, jsecs[0])
    _carried(tmodel, variables)
    jstate = JaxTrainState(step=0, params=variables["params"], batch_stats={},
                           opt_state=None, tx=None)
    want = jax_trainer.bleep_embeddings(jmodel, jstate, jsecs)
    got = trainer.bleep_embeddings(tmodel, tsecs)
    return want, got, jsecs, tsecs


def test_bleep_embeddings_match_jax(embeddings_case):
    """Every spot's (image, spot) projections in section order, the images
    divided eagerly as JAX's ``bleep_embeddings`` divides them."""
    want, got, jsecs, _ = embeddings_case
    for g, w in zip(got, want):
        assert g.shape == (sum(s.num_spots for s in jsecs), 256)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("top_k,weight_ord", [(1, 0), (50, 0), (50, -1)],
                         ids=["simple", "average", "weighted"])
def test_evaluate_fold_modes_match_jax(embeddings_case, top_k, weight_ord):
    """The JAX CLI's three BLEEP retrieval modes (nearest match, uniform
    top-50, exp(-(d^2 - d_top^2 + 1)) top-50) on each package's embeddings:
    the fold's metrics agree, all finite."""
    (jimg, jspot), (img, spot), jsecs, tsecs = embeddings_case
    sizes = [s.num_spots for s in jsecs]
    for fold in range(len(sizes)):
        want = jax_evaluate.evaluate_fold(
            fold, jax_embed.split_by_section(jimg, sizes)[fold],
            jax_embed.split_by_section(jspot, sizes), [s.eval_expression for s in jsecs],
            top_k=top_k, weight_ord=weight_ord)
        got = evaluate.evaluate_fold(
            fold, embed.split_by_section(img, sizes)[fold], embed.split_by_section(spot, sizes),
            [s.eval_expression for s in tsecs], top_k=top_k, weight_ord=weight_ord,
            device="cpu")
        assert sorted(got) == sorted(want) and all(np.isfinite(v) for v in got.values())
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)


def test_state_dict_imports_back_into_jax():
    """A res18 BLEEP's state_dict (``image_encoder.model.*``, the two
    projection heads) through the JAX package's ``IMPORTERS["bleep"]``
    gives back the flax tree exactly, batch stats included."""
    jmodel, tmodel = _models("res18")
    jsecs, _ = _sections(n=4, num=1)
    variables = _variables(jmodel, jsecs[0])
    _carried(tmodel, variables)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert any(k.startswith("image_encoder.model.") for k in sd)
    params, stats = jax_import.IMPORTERS["bleep"](sd, jmodel)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for got, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key
