"""The slide-level baselines of the port (HisToGene, THItoGene) against the
JAX package.

Both packages get the same numpy inputs; the port's weights come from the
JAX variables through ``interop.baseline_params_from_jax``. Widths are
small: HisToGene dim 32, 2 layers of 2 heads, 16-px patches; THItoGene at
112-px patches (its capsule trunk needs them) with 4 capsules of 8, 1
layer, heads (2, 2); slides padded to a bucket of 16.

Tolerances: forwards atol 1e-4 (fp32, sums in another order: convolutions,
einsums, the batched ODConv product); a padded slide's real rows against
the unpadded slide's atol 2e-5 in the port; 3-step trajectories at dropout
0, each step from the JAX trajectory's state: losses rtol 1e-4, gradients
within 1e-4 of each tensor's largest magnitude of ``jax.grad``'s (1e-1 in
THItoGene's patch trunk, where the JAX reference's own fp32 rounding is
amplified: see ``TRUNK``; the first step's also within 1e-4 of a float64
evaluation of the port), each update within 0.05 lr of JAX's (an Adam step
moves an element by about lr, so a skipped or reversed step fails);
masked batch-norm statistics rtol 1e-5; ``knn_adjacency``, ``pad_slide``
and the slide order exact; both uint8 scalings bit-equal to JAX's.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu.baselines import graph as jax_graph
from mclstexp_tpu.baselines import models as jax_models
from mclstexp_tpu.baselines import torch_import as jax_import
from mclstexp_tpu.baselines import trainer as jax_trainer
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.models.image.common import BatchNormT as JaxBatchNormT
from mclstexp_tpu.train.state import TrainState as JaxTrainState
from mclstexp_tpu.train.state import torch_adam as jax_torch_adam
from mclstexp_tpu_torch import interop
from mclstexp_tpu_torch.baselines import graph, models, trainer
from mclstexp_tpu_torch.core.layers import SeededDropout, seed_dropout
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.models.image.common import MaskedBatchNormT
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.parallel import distributed
from mclstexp_tpu_torch.parallel.mesh import make_mesh
from mclstexp_tpu_torch.train.state import TrainState, torch_adam

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-4)
G = 8


def _small(family, dropout=0.0):
    """(JAX model, port model on the CPU, patch size) at test widths."""
    if family == "histogene":
        return (jax_models.HisToGene(n_genes=G, patch_size=16, dim=32, n_layers=2, heads=2,
                                     dropout=dropout),
                models.HisToGene(G, 16, dim=32, n_layers=2, heads=2, dropout=dropout,
                                 device="cpu"), 16)
    return (jax_models.THItoGene(n_genes=G, patch_size=112, dim=32, n_layers=1, caps=4,
                                 route_dim=8, heads=(2, 2), dropout=dropout),
            models.THItoGene(G, 112, dim=32, n_layers=1, caps=4, route_dim=8, heads=(2, 2),
                             dropout=dropout, device="cpu"), 112)


def _sections(sizes, patch, seed=0):
    """The same synthetic sections in both packages (the port's
    ``make_section`` reproduces the JAX one's arrays)."""
    loadings = np.random.default_rng(seed).normal(size=(4, G))
    make = lambda mod: [mod.make_section(f"S{i}", n, G, patch, seed=seed + i,  # noqa: E731
                                         gene_loadings=loadings)
                        for i, n in enumerate(sizes)]
    return make(jax_synthetic), make(synthetic)


def _cfg(family, patch, **kw):
    return dict(model=family, n_genes=G, patch_size=patch, bucket=16, **kw)


def _jax_variables(jmodel, batch, family):
    patches = batch["patches"].astype(np.float32) / 255.0
    args = (patches, batch["positions"]) + ((batch["adj"],) if family == "thitogene" else ())
    return jax.device_get(jmodel.init(jax.random.PRNGKey(0), *args))


def _carried(tmodel, variables):
    tmodel.load_state_dict(interop.baseline_params_from_jax(
        tmodel, variables["params"], variables.get("batch_stats", {})), strict=True)
    return tmodel


def _padded_batch(jsec, family, patch):
    cfg = jax_trainer.BaselineConfig(**_cfg(family, patch))
    return jax_trainer.pad_slide(jsec, 16, family == "thitogene", cfg)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", ["histogene", "thitogene"])
def test_forward_matches_jax(family, train):
    """The padded slide's forward, every row (on the CPU "xla" and "flash"
    both take the key mask, as the JAX module does off a TPU); in train mode
    also the batch norms' new running stats."""
    jmodel, tmodel, patch = _small(family)
    jsecs, _ = _sections([21], patch)
    batch = _padded_batch(jsecs[0], family, patch)
    variables = _jax_variables(jmodel, batch, family)
    _carried(tmodel, variables)
    patches = batch["patches"].astype(np.float32) / np.float32(255)
    args = (patches, batch["positions"]) + ((batch["adj"],) if family == "thitogene" else ())
    out = jmodel.apply(variables, *args, train=train, mask=batch["mask"],
                       mutable=["batch_stats"] if train else False)
    want, updates = out if train else (out, None)
    tmodel.train(train)
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, args), mask=torch.from_numpy(batch["mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    if train and family == "thitogene":
        sd = interop.baseline_params_from_jax(tmodel, variables["params"],
                                              jax.device_get(updates["batch_stats"]))
        for key, value in sd.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(tmodel.state_dict()[key].numpy(), value.numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_spot_vit_matches_jax(backend):
    """SpotViT alone (emb dropout, pre-LN blocks, no final LN) with a mask."""
    jvit = jax_models.SpotViT(32, 2, 2, 64, backend=backend)
    tvit = models.SpotViT(32, 2, 2, 64, backend=backend, device="cpu")
    x = np.random.default_rng(1).normal(size=(1, 24, 32)).astype(np.float32)
    mask = np.arange(24) < 19
    params = jax.device_get(jvit.init(jax.random.PRNGKey(1), x))["params"]
    conv = interop._Converter({"vit": params}, {})
    interop._slide_vit(conv, 2)
    tvit.load_state_dict({k[len("vit."):]: v for k, v in conv.out.items()}, strict=True)
    want = jvit.apply({"params": params}, x, mask=jnp.asarray(mask))
    got = tvit(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("shape", [(12, 6), (12, 5, 5, 6)], ids=["pooled", "maps"])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_train_statistics_match_jax(shape, masked):
    """MaskedBatchNormT in train mode: the normalized output and the running
    stats (mean, unbiased variance, 0.9 EMA) of the JAX BatchNormT, over the
    masked samples only; at eval the running stats serve."""
    r = np.random.default_rng(len(shape))
    x = (r.normal(size=shape) * 3 + 2).astype(np.float32)  # NHWC / (N, C)
    mask = np.arange(shape[0]) % 3 != 2 if masked else None
    jbn = JaxBatchNormT(use_running_average=False)
    variables = jbn.init(jax.random.PRNGKey(0), x)
    want, upd = jbn.apply(variables, x, None if mask is None else jnp.asarray(mask),
                          mutable=["batch_stats"])
    bn = MaskedBatchNormT(shape[-1], device="cpu").train()
    tx = torch.from_numpy(np.moveaxis(x, -1, 1).copy())  # channels on dim 1
    got = bn(tx, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]), rtol=1e-5, atol=1e-6)
    bn.eval()
    with torch.no_grad():
        eval_out = bn(tx, torch.zeros(shape[0], dtype=torch.bool))
    want_eval = jbn.clone(use_running_average=True).apply(
        {"params": variables["params"], **upd}, x)
    np.testing.assert_allclose(np.moveaxis(eval_out.numpy(), 1, -1), np.asarray(want_eval),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["histogene", "thitogene"])
def test_padded_slide_equals_unpadded_on_real_rows(family):
    """Train mode in the port: a slide padded with a mask gives the unpadded
    slide's predictions on its real rows and the same running stats."""
    _, tmodel, patch = _small(family)
    models.init_baseline_parameters(tmodel, torch.Generator().manual_seed(0))
    r = np.random.default_rng(3)
    n, pad = 11, 5
    patches = torch.from_numpy(r.uniform(size=(n, patch, patch, 3)).astype(np.float32))
    pos = torch.from_numpy(r.integers(0, 64, size=(n, 2)).astype(np.int32))
    adj = torch.from_numpy(graph.knn_adjacency(pos.numpy(), k=2, prune="none"))
    p_patches = torch.cat([patches, torch.zeros((pad, patch, patch, 3))])
    p_pos = torch.cat([pos, torch.zeros((pad, 2), dtype=torch.int32)])
    p_adj = torch.zeros((n + pad, n + pad))
    p_adj[:n, :n] = adj
    mask = torch.arange(n + pad) < n
    extra, p_extra = ((adj,), (p_adj,)) if family == "thitogene" else ((), ())
    twin = _small(family)[1]
    twin.load_state_dict(tmodel.state_dict())
    tmodel.train()
    twin.train()
    with torch.no_grad():
        want = tmodel(patches, pos, *extra)
        got = twin(p_patches, p_pos, *p_extra, mask=mask)
    torch.testing.assert_close(got[:n], want, rtol=2e-4, atol=2e-5)
    for (key, a), b in zip(twin.state_dict().items(), tmodel.state_dict().values()):
        if key.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(a, b, rtol=5e-5, atol=1e-5, msg=key)


def test_gat_isolated_spot_matches_jax_and_ignores_padding():
    """MultiHeadGAT with a real spot whose adjacency row is empty: the
    -9e15 non-neighbour fill and the lower -1e30 pad-column fill keep its
    uniform softmax over real spots, so the padded graph gives the unpadded
    answer; both equal the JAX module's."""
    from mclstexp_tpu.baselines.layers import MultiHeadGAT as JaxGAT

    from mclstexp_tpu_torch.baselines.layers import MultiHeadGAT

    r = np.random.default_rng(5)
    n, pad, f = 5, 3, 8
    x = r.normal(size=(n, f)).astype(np.float32)
    adj = np.ones((n, n), np.float32)
    adj[2, :] = adj[:, 2] = 0.0  # an isolated real spot
    jgat = JaxGAT(nhid=4, out_features=6, heads=2, dropout=0.0, alpha=0.01)
    params = jax.device_get(jgat.init(jax.random.PRNGKey(0), x, jnp.asarray(adj)))["params"]
    gat = MultiHeadGAT(f, 4, 6, heads=2, dropout=0.0, device="cpu")
    with torch.no_grad():
        for name in ("attention_0", "attention_1", "out_att"):
            getattr(gat, name).W.copy_(torch.from_numpy(np.array(params[name]["W"]["kernel"])))
            getattr(gat, name).a.copy_(torch.from_numpy(np.array(params[name]["a"])))
    x_p = np.concatenate([x, np.zeros((pad, f), np.float32)])
    adj_p = np.zeros((n + pad, n + pad), np.float32)
    adj_p[:n, :n] = adj
    mask = np.arange(n + pad) < n
    want = jgat.apply({"params": params}, x, jnp.asarray(adj))
    with torch.no_grad():
        got = gat(torch.from_numpy(x), torch.from_numpy(adj))
        got_p = gat(torch.from_numpy(x_p), torch.from_numpy(adj_p), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_p[:n].numpy(), got.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prune", ["grid", "std", "none"])
@pytest.mark.parametrize("metric", ["euclidean", "cityblock"])
def test_knn_adjacency_is_the_jax_matrix(metric, prune):
    """Exact, on grid coordinates (many equal distances: argsort's ties
    fall as in the JAX copy) and on random ones, k = 4 and k = 0 (all)."""
    r = np.random.default_rng(4)
    grid = np.stack(np.meshgrid(np.arange(7), np.arange(6)), -1).reshape(-1, 2)[:40]
    for coords in (grid, r.integers(0, 30, size=(50, 2))):
        for k in (4, 0):
            want = jax_graph.knn_adjacency(coords, k=k, metric=metric, prune=prune)
            got = graph.knn_adjacency(coords, k=k, metric=metric, prune=prune)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pad_slide_is_the_jax_dict():
    jsecs, tsecs = _sections([21, 32], 16)
    for with_adj in (False, True):
        for js, ts in zip(jsecs, tsecs):
            want = jax_trainer.pad_slide(js, 16, with_adj,
                                         jax_trainer.BaselineConfig(**_cfg("thitogene", 16)))
            got = trainer.pad_slide(ts, 16, with_adj,
                                    trainer.BaselineConfig(**_cfg("thitogene", 16)))
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


def _sync_from_jax(state, jstate):
    """The port's parameters, batch-norm stats and Adam moments set to the
    JAX state's, so that one step is compared from one state."""
    model = state.model
    model.load_state_dict(interop.baseline_params_from_jax(
        model, jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    adam = next(s for s in jstate.opt_state if hasattr(s, "mu"))
    moments = [interop.baseline_params_from_jax(model, jax.device_get(tree),
                                                jax.device_get(jstate.batch_stats))
               for tree in (adam.mu, adam.nu)]
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                    "exp_avg": moments[0][name].clone(),
                                    "exp_avg_sq": moments[1][name].clone()}


GRAD_TOL = 1e-4  # of each gradient's largest magnitude
# THItoGene's patch trunk (ODConv and the capsule convs with their batch
# norms) normalizes low-variance maps behind ReLUs, which amplifies
# rounding: there the JAX package's fp32 gradients on the CPU lie up to
# 1.7e-2 of the largest magnitude from a float64 evaluation of the port,
# while the port's fp32 ones stay within 1e-4 of it (``_fp64_grads``, held
# below); over the three steps JAX and the port differ there by up to 3.6e-2.
TRUNK = ("odconv2d.", "caps_layer.conv", "caps_layer.batch_norm")
TRUNK_GRAD_TOL = 1e-1
# A conv's bias that feeds a batch norm has a zero gradient up to rounding
# (the norm subtracts the mean): both sides must be that small.
BIAS_BEFORE_BN = ("caps_layer.conv1.bias", "caps_layer.conv2.bias", "caps_layer.conv3.bias",
                  "caps_layer.conv4.bias")
UPDATE_TOL = 0.05  # of lr: an Adam step moves an element by about lr


def _fp64_grads(model, family, batch):
    """The slide loss's gradients from a float64 copy of ``model`` on the
    same padded slide: what the port's fp32 gradients are held to at 1e-4
    everywhere, the patch trunk (``TRUNK``) included."""
    twin = copy.deepcopy(model).double().train()
    b = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    args = (batch["patches"].double() / 255.0, b["positions"])
    pred = twin(*args + ((b["adj"],) if family == "thitogene" else ()), mask=b["mask"])
    trainer.masked_mse(pred, b["expression"], b["mask"]).backward()
    return {name: p.grad.float() for name, p in twin.named_parameters()}


def _assert_step_matches(tmodel, before, grads, want_grads, want_after, lr, i,
                         near_zero=BIAS_BEFORE_BN, loose=TRUNK, loose_tol=TRUNK_GRAD_TOL):
    """One step against JAX's from the same state: every gradient within
    its tolerance of ``jax.grad``'s, and every element's update (after -
    before) within 0.05 lr of JAX's wherever the gradient's sign is sure
    (larger than the tolerance); that must be three quarters of the
    elements or more, so a skipped or reversed step fails. ``near_zero``:
    the biases whose gradient is zero up to rounding (a batch norm follows
    them), held below 1e-5 of the largest gradient on both sides; the
    tensors named with a prefix in ``loose`` at ``loose_tol`` of their
    largest magnitude. Batch-norm running stats rtol 1e-4."""
    scale = max(float(np.abs(w.numpy()).max()) for w in want_grads.values())
    after = tmodel.state_dict()
    checked = total = 0
    for name, g in grads.items():
        g, w = g.numpy(), want_grads[name].numpy()
        if name in near_zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-5 * scale, f"step {i}: {name}"
            continue
        tol = (loose_tol if name.startswith(loose) else GRAD_TOL) * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"step {i}: grad {name}")
        sure = np.abs(w) > tol
        step = (after[name] - before[name]).numpy()
        want_step = (want_after[name] - before[name]).numpy()
        np.testing.assert_allclose(step[sure], want_step[sure], rtol=0, atol=UPDATE_TOL * lr,
                                   err_msg=f"step {i}: update {name}")
        checked, total = checked + int(sure.sum()), total + w.size
    assert checked >= 0.75 * total, f"step {i}: only {checked} of {total} updates checked"
    for key, value in want_after.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(after[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i}: {key}")


@pytest.mark.parametrize("family", ["histogene", "thitogene"])
def test_three_slide_steps_match_jax(family):
    """make_slide_step at dropout 0 on three padded slides, each step from
    the JAX trajectory's state (weights, batch-norm stats, Adam moments):
    the loss within rtol 1e-4 of JAX's, the gradients against ``jax.grad``
    of the JAX slide loss, and each element's update against JAX's Adam
    step (``_assert_step_matches``); the first step's gradients also
    against a float64 evaluation of the port (``_fp64_grads``)."""
    jmodel, tmodel, patch = _small(family)
    lr = 1e-3
    jsecs, tsecs = _sections([21, 13, 30], patch)
    jcfg = jax_trainer.BaselineConfig(**_cfg(family, patch, lr=lr, dropout=0.0))
    tcfg = trainer.BaselineConfig(**_cfg(family, patch, lr=lr, dropout=0.0))
    with_adj = family == "thitogene"
    jbatches = [jax_trainer.pad_slide(s, 16, with_adj, jcfg) for s in jsecs]
    variables = _jax_variables(jmodel, jbatches[0], family)
    tx = jax_torch_adam(lr, 0.0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables.get("batch_stats", {}),
                           opt_state=tx.init(variables["params"]), tx=tx)
    state = TrainState(_carried(tmodel, variables), torch_adam(tmodel.parameters(), lr, 0.0))
    jstep, step = jax_trainer.make_slide_step(jmodel, jcfg, donate=False), \
        trainer.make_slide_step(tcfg)
    jgrad = jax.jit(jax.grad(lambda params, stats, batch, rng: jax_trainer._slide_loss(
        jmodel, jcfg, params, stats, batch, rng)[0]))
    generator = torch.Generator()
    for i, (jb, ts) in enumerate(zip(jbatches, tsecs)):
        if i:
            _sync_from_jax(state, jstate)
        jbatch, rng = {k: jnp.asarray(v) for k, v in jb.items()}, jax.random.PRNGKey(i)
        jgrads = jgrad(jstate.params, jstate.batch_stats, jbatch, rng)
        want_grads = interop.baseline_params_from_jax(tmodel, jax.device_get(jgrads),
                                                      jax.device_get(jstate.batch_stats))
        jstate, jloss = jstep(jstate, jbatch, rng)
        before = {k: v.clone() for k, v in tmodel.state_dict().items()}
        batch = trainer.slide_tensors(trainer.pad_slide(ts, 16, with_adj, tcfg), "cpu")
        exact = _fp64_grads(tmodel, family, batch) if i == 0 else None
        loss = step(state, batch, augment.reseed(generator, 0, i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        want_after = interop.baseline_params_from_jax(tmodel, jax.device_get(jstate.params),
                                                      jax.device_get(jstate.batch_stats))
        grads = {name: p.grad for name, p in tmodel.named_parameters()}
        _assert_step_matches(tmodel, before, grads, want_grads, want_after, lr, i)
        for name in exact or ():
            if name not in BIAS_BEFORE_BN:
                e = exact[name].numpy()
                np.testing.assert_allclose(grads[name].numpy(), e, rtol=0,
                                           atol=GRAD_TOL * np.abs(e).max(),
                                           err_msg=f"float64: {name}")
    assert state.step == 3


def test_slide_order_is_the_jax_order(monkeypatch):
    """train_baseline_fold visits the training slides in the JAX loop's
    order, epoch by epoch (each slide known by its spot count)."""
    sizes = [20, 13, 30, 17, 25]
    jsecs, tsecs = _sections(sizes, 16)
    kw = _cfg("histogene", 16, max_epochs=3, n_layers=1, seed=7)
    seen_jax, seen = [], []

    def jax_fake(model, cfg, donate=True):
        def step(state, batch, rng):
            seen_jax.append(int(np.asarray(batch["mask"]).sum()))
            return state, jnp.float32(0.0)
        return step

    def fake(cfg, steps_per_epoch=1):
        assert steps_per_epoch == len(sizes) - 1  # an epoch: one step per training slide

        def step(state, batch, generator):
            seen.append(int(batch["mask"].sum()))
            return torch.zeros(())
        return step

    monkeypatch.setattr(jax_trainer, "make_slide_step", jax_fake)
    monkeypatch.setattr(trainer, "make_slide_step", fake)
    jax_trainer.train_baseline_fold(jax_trainer.BaselineConfig(**kw), jsecs, 1)
    state = trainer.train_baseline_fold(trainer.BaselineConfig(**kw), tsecs, 1, device="cpu")
    assert len(seen) == 12 and seen == seen_jax
    assert isinstance(state.model, models.HisToGene)


@pytest.mark.parametrize("family", ["histogene", "thitogene"])
def test_predict_and_evaluate_match_jax(family):
    """predict_slide (eval mode, running stats moved by one train-mode pass)
    and evaluate_baseline_fold's metrics against the JAX functions."""
    jmodel, tmodel, patch = _small(family)
    jsecs, tsecs = _sections([21, 13], patch, seed=2)
    cfg_kw = _cfg(family, patch)
    jcfg, tcfg = jax_trainer.BaselineConfig(**cfg_kw), trainer.BaselineConfig(**cfg_kw)
    batch = _padded_batch(jsecs[0], family, patch)
    variables = _jax_variables(jmodel, batch, family)
    patches = batch["patches"].astype(np.float32) / np.float32(255)
    args = (patches, batch["positions"]) + ((batch["adj"],) if family == "thitogene" else ())
    _, upd = jmodel.apply(variables, *args, train=True, mask=batch["mask"],
                          mutable=["batch_stats"])
    variables = {"params": variables["params"], **jax.device_get(upd)}
    jstate = JaxTrainState(step=0, params=variables["params"],
                           batch_stats=variables.get("batch_stats", {}), opt_state=None,
                           tx=None)
    _carried(tmodel, variables)
    for js, ts in zip(jsecs, tsecs):
        want = jax_trainer.predict_slide(jmodel, jstate, js, jcfg)
        got = trainer.predict_slide(tmodel, ts, tcfg)
        assert got.shape == (ts.num_spots, G)
        np.testing.assert_allclose(got, want, **FWD_TOL)
    want = jax_trainer.evaluate_baseline_fold(jcfg, jsecs, 1, jmodel, jstate)
    got = trainer.evaluate_baseline_fold(tcfg, tsecs, 1, tmodel)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)


class _Recorder(torch.nn.Module):
    """A stand-in model that keeps the patches it is given."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, patches, positions, mask=None):
        self.seen = patches
        return torch.zeros((patches.shape[0], G)) + self.w


def test_uint8_sites_scale_like_jax():
    """All 256 uint8 values: the train loss's input bit-equal to the jitted
    JAX ``u8 / 255.0`` (a multiply by float32(1/255)), predict_slide's to
    the eager one (a true division); the two differ on some values."""
    u8 = np.tile(np.arange(256, dtype=np.uint8), 3).reshape(1, 16, 16, 3)
    jitted = np.asarray(jax.jit(lambda u: u.astype(jnp.float32) / 255.0)(u8))
    eager = np.asarray(jnp.asarray(u8).astype(jnp.float32) / 255.0)
    assert (jitted != eager).any()
    cfg = trainer.BaselineConfig(**_cfg("histogene", 16))
    rec = _Recorder()
    batch = {"patches": torch.from_numpy(u8), "positions": torch.zeros((1, 2), dtype=torch.int32),
             "expression": torch.zeros((1, G)), "mask": torch.ones(1, dtype=torch.bool)}
    trainer.slide_loss(rec, cfg, batch)
    assert np.array_equal(rec.seen.numpy().view(np.uint32), jitted.view(np.uint32))
    _, (section,) = _sections([1], 16)
    section = dataclasses.replace(section, patches=u8)
    trainer.predict_slide(rec, section, cfg)
    assert np.array_equal(rec.seen[:1].numpy().view(np.uint32), eager.view(np.uint32))
    assert np.array_equal(trainer.to_float_eager(torch.from_numpy(u8)).numpy().view(np.uint32),
                          eager.view(np.uint32))


def test_dropout_is_reproducible_and_keeps_its_rate():
    """SeededDropout draws from the step's generator: the same (seed, epoch,
    slide) key gives the same mask, another key another; the keep rate is
    within 4 sigma of 1 - p and kept values are scaled by 1 / (1 - p); a
    train-mode call without a generator raises; eval is the identity."""
    p, size = 0.1, 200_000
    drop = SeededDropout(p).train()
    x = torch.ones(size)
    with pytest.raises(RuntimeError, match="seed_dropout"):
        drop(x)
    g = torch.Generator()
    seed_dropout(drop, augment.reseed(g, 3, 2 * 1000 + 1))
    a = drop(x)
    seed_dropout(drop, augment.reseed(g, 3, 2 * 1000 + 1))
    b = drop(x)
    seed_dropout(drop, augment.reseed(g, 3, 2 * 1000 + 2))
    c = drop(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    sigma = (p * (1 - p) / size) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - p)) < 4 * sigma
    assert torch.equal(a[kept], torch.full_like(a[kept], 1.0) / (1 - p))
    assert torch.equal(drop.eval()(x), x)
    model = _small("histogene", dropout=0.1)[1]  # every dropout of the model seeded
    models.init_baseline_parameters(model, torch.Generator().manual_seed(0))
    assert not any(isinstance(m, torch.nn.Dropout) for m in model.modules())
    patches, pos = torch.rand((6, 16, 16, 3)), torch.zeros((6, 2), dtype=torch.int32)
    outs = []
    for key in (5, 5, 6):
        seed_dropout(model, augment.reseed(g, 0, key))
        outs.append(model.train()(patches, pos))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("family", ["histogene", "thitogene"])
def test_state_dict_imports_back_into_jax(family):
    """The port's state_dict (reference torch keys) through the JAX
    package's ``import_<family>_state_dict`` gives back the flax tree."""
    jmodel, tmodel, patch = _small(family)
    jsecs, _ = _sections([16], patch)
    variables = _jax_variables(jmodel, _padded_batch(jsecs[0], family, patch), family)
    _carried(tmodel, variables)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    params, stats = jax_import.IMPORTERS[family](sd, jmodel)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for got, want in ((params, variables["params"]), (stats, variables.get("batch_stats", {}))):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key


def test_unported_families_and_modes_raise(monkeypatch):
    """Every family builds (Hist2ST and BLEEP since they were ported); what
    raises is an unknown name and a dtype other than float32 / bfloat16.
    The multi-device modes, which raised before they were ported, run: the
    slide-DP mode on one process (two slides a step) and over a one-rank
    mesh, and BLEEP's ``mesh=`` (tests/test_torch_port_dp.py holds them to
    one process at world sizes 2 and 3)."""
    hist2st = trainer.build_baseline(trainer.BaselineConfig(model="hist2st"), device="cpu")
    assert isinstance(hist2st, models.Hist2ST) and hist2st.dim == 1024 and hist2st.coef_head
    bleep = trainer.build_baseline(trainer.BaselineConfig(model="bleep", n_genes=G,
                                                          encoder_name="tiny_cnn"), device="cpu")
    assert isinstance(bleep, models.BLEEP)
    with pytest.raises(KeyError):
        trainer.build_baseline(trainer.BaselineConfig(model="nope"), device="cpu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trainer.build_baseline(trainer.BaselineConfig(dtype="float16"), device="cpu")
    cfg = trainer.BaselineConfig(**_cfg("histogene", 16, max_epochs=1))
    _, tsecs = _sections([10, 12], 16)
    _, tsecs = _sections([10, 12, 9], 16)
    small = dict(dim=32, n_layers=1, heads=2)
    try:
        mesh = make_mesh(device="cpu")  # a one-rank gloo group
        for kw, steps in ((dict(mesh=mesh), 2), (dict(slides_per_step=2), 1)):  # slide-DP
            with monkeypatch.context() as m:
                m.setattr(trainer, "build_baseline", lambda c, device, attn_backend: (
                    models.HisToGene(G, 16, dropout=0.1, device=device, **small)))
                state = trainer.train_baseline_fold(cfg, tsecs, 0, device="cpu", **kw)
            assert state.step == steps
        state = trainer.train_bleep_fold(  # BLEEP's data-parallel mode
            trainer.BaselineConfig(model="bleep", n_genes=G, patch_size=16, max_epochs=1,
                                   batch_size=8, encoder_name="tiny_cnn"),
            tsecs, 0, device="cpu", mesh=mesh)
        assert state.step == 3  # 21 spots in batches of 8
    finally:
        distributed.shutdown()
    assert trainer.resolve_bake(trainer.BaselineConfig(model="hist2st", bake=2)) == 2
    assert trainer.resolve_bake(trainer.BaselineConfig(model="hist2st")) == 5
    assert trainer.resolve_bake(cfg) == 0
    assert trainer.resolve_lr(cfg) == 1e-5 and trainer.resolve_n_layers(cfg) == 8
    assert trainer.resolve_epochs(trainer.BaselineConfig(model="thitogene")) == 300
    assert trainer.resolve_epochs(trainer.BaselineConfig(model="hist2st")) == 350
    bleep_cfg = trainer.BaselineConfig(model="bleep")
    assert (trainer.resolve_lr(bleep_cfg), trainer.resolve_weight_decay(bleep_cfg),
            trainer.resolve_epochs(bleep_cfg)) == (1e-3, 1e-3, 4)


@pytest.mark.parametrize("family", ["histogene", "thitogene"])
def test_baselines_build_in_bfloat16(family):
    """BaselineConfig(dtype="bfloat16"): fp32 parameters, the computing
    modules in bf16; the fp32 model's state loads into it as it is."""
    kw = dict(model=family, n_genes=8, n_layers=1, patch_size=112 if family == "thitogene" else 16)
    model32 = trainer.build_baseline(trainer.BaselineConfig(**kw), device="cpu")
    model = trainer.build_baseline(trainer.BaselineConfig(dtype="bfloat16", **kw), device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    computing = [m for m in model.modules() if hasattr(type(m), "compute_dtype")]
    assert computing and all(m.compute_dtype == torch.bfloat16 for m in computing)
    model.load_state_dict(model32.state_dict(), strict=True)
