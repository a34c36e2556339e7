"""Hist2ST in the port against the JAX package.

Both packages get the same numpy inputs; the port's weights come from the
JAX variables through ``interop.baseline_params_from_jax``. Widths: 28-px
figures, a 7 x 7 patchify, 16 channels (dim 32), 1 mixer, 1 attention block
of 2 heads of 64, 2 GraphSAGE blocks, 8 genes; slides padded to a bucket of
16.

Tolerances: the losses rtol 1e-5 (their gradients within 1e-5 of the
largest magnitude: torch's and XLA's digamma differ in the last bits); the mixer's masked
train-mode statistics rtol 1e-5; GraphSAGE atol 1e-6; forwards atol 1e-4
(fp32, sums in another order); a padded slide's real rows against the
unpadded slide's in the port rtol 2e-4 / atol 2e-5; three slide steps at
dropout 0 with zinb and bake 2, each from the JAX trajectory's state: losses
rtol 1e-4, gradients within 1e-4 of each tensor's largest magnitude,
updates within 0.05 lr, the chained running statistics rtol 1e-4 (the coef
head's gradients 1e-3 of JAX's and 1e-4 of a float64 evaluation: ``COEF``); StepLR's
updates rtol 5e-5; state dicts back into the JAX importer exactly.

The bake's nearest rotation is not bit-equal to JAX's jitted one at every
angle: XLA fuses cos*x - sin*y into an FMA, and JAX's float32 cos and sin
differ from torch's in the last bit for some angles, so a source coordinate
within rounding of a .5 tie may round the other way. The bake test states
that rule (``test_bake_matches_the_jitted_jax_bake``); the step test feeds
both packages the same baked tensor.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_baselines import _assert_step_matches, _sync_from_jax

from mclstexp_tpu.baselines import layers as jax_layers
from mclstexp_tpu.baselines import losses as jax_losses
from mclstexp_tpu.baselines import models as jax_models
from mclstexp_tpu.baselines import torch_import as jax_import
from mclstexp_tpu.baselines import trainer as jax_trainer
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.train.state import TrainState as JaxTrainState
from mclstexp_tpu_torch import interop
from mclstexp_tpu_torch.baselines import layers, losses, models, trainer
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

G, FIG, BUCKET = 8, 28, 16
WIDTHS = dict(fig_size=FIG, patch_size=7, channel=16, depth1=1, depth2=1, depth3=2, heads=2)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = {"zinb": dict(zinb=True), "nb": dict(zinb=True, nb=True),
            "coef": dict(zinb=True, coef_head=True)}
# zero gradients up to rounding: the conv biases that feed a batch norm, and
# coef's last bias, which adds the same to every bake before their softmax
NEAR_ZERO = ("vit.transformer.layer1.0.dw.0.bias", "vit.transformer.layer1.0.dw.3.bias",
             "coef.2.bias")
_JAX_BAKE = jax_trainer._bake_augment  # the JAX bake (the step test replaces the module's)


def _jitted_bake(key, u8, n_bake):
    """The JAX step's bakes of uint8 patches: ``_bake_augment``, jitted, on
    the float32 patches of the jitted step's scaling."""
    return np.array(jax.jit(lambda k, u: _JAX_BAKE(k, u.astype(jnp.float32) / 255.0, n_bake))(
        key, jnp.asarray(u8)))


def _models(dropout=0.0, **kw):
    return (jax_models.Hist2ST(n_genes=G, dropout=dropout, **WIDTHS, **kw),
            models.Hist2ST(G, dropout=dropout, device="cpu", **WIDTHS, **kw))


def _sections(sizes, seed=0):
    loadings = np.random.default_rng(seed).normal(size=(4, G))
    make = lambda mod: [mod.make_section(f"S{i}", n, G, FIG, seed=seed + i,  # noqa: E731
                                         gene_loadings=loadings)
                        for i, n in enumerate(sizes)]
    return make(jax_synthetic), make(synthetic)


def _cfg(**kw):
    return dict(model="hist2st", n_genes=G, patch_size=FIG, bucket=BUCKET, **kw)


def _args(batch):
    patches = batch["patches"].astype(np.float32) / np.float32(255)
    return patches, batch["positions"], batch["adj"]


def _variables(jmodel, batch):
    return jax.device_get(jmodel.init(jax.random.PRNGKey(0), *_args(batch),
                                      aug=jmodel.coef_head))


def _carried(tmodel, variables):
    tmodel.load_state_dict(interop.baseline_params_from_jax(
        tmodel, variables["params"], variables.get("batch_stats", {})), strict=True)
    return tmodel


def _padded(jsec, **kw):
    return jax_trainer.pad_slide(jsec, BUCKET, True, jax_trainer.BaselineConfig(**_cfg(**kw)))


def _loss_inputs(rng, n=12, g=6):
    """Counts with many zeros, head outputs, size factors and a mask."""
    x = rng.poisson(0.7, size=(n, g)).astype(np.float32)
    assert (x == 0).mean() > 0.3
    return dict(x=x, mean=rng.uniform(0.2, 3.0, (n, g)).astype(np.float32),
                disp=rng.uniform(0.3, 4.0, (n, g)).astype(np.float32),
                pi=rng.uniform(0.05, 0.9, (n, g)).astype(np.float32),
                sf=rng.uniform(0.5, 2.0, n).astype(np.float32),
                log_r=rng.normal(size=(n, g)).astype(np.float32),
                logit_p=rng.normal(size=(n, g)).astype(np.float32),
                mask=np.arange(n) < n - 3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["zinb", "nb"])
def test_losses_match_jax(kind, masked):
    """zinb_loss and nb_loss (masked: pad rows contribute nothing) against
    the JAX functions, rtol 1e-5, at inputs with zero counts; their
    gradients finite there and within 1e-5 of each one's largest magnitude
    of ``jax.grad``'s; the activations rtol 1e-6."""
    d = _loss_inputs(np.random.default_rng(1))
    mask = d["mask"] if masked else None
    if kind == "zinb":
        names = ("mean", "disp", "pi")
        jf = lambda m, dd, p: jax_losses.zinb_loss(d["x"], m, dd, p, d["sf"],  # noqa: E731
                                                   mask=mask)
        tf = lambda m, dd, p: losses.zinb_loss(  # noqa: E731
            torch.from_numpy(d["x"]), m, dd, p, torch.from_numpy(d["sf"]),
            mask=None if mask is None else torch.from_numpy(mask))
    else:
        names = ("log_r", "logit_p")
        jf = lambda r, p: jax_losses.nb_loss(d["x"], r, p, mask=mask)  # noqa: E731
        tf = lambda r, p: losses.nb_loss(  # noqa: E731
            torch.from_numpy(d["x"]), r, p, mask=None if mask is None else torch.from_numpy(mask))
    inputs = [d[k] for k in names]
    want, want_grads = jax.value_and_grad(jf, argnums=tuple(range(len(names))))(*inputs)
    tensors = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = tf(*tensors)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, t, w in zip(names, tensors, want_grads):
        assert torch.isfinite(t.grad).all(), name
        w = np.asarray(w)  # digamma differs in its last bits: 1e-5 of the largest
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    z = np.linspace(-30, 30, 61).astype(np.float32)
    for jact, tact in ((jax_losses.mean_act, losses.mean_act),
                       (jax_losses.disp_act, losses.disp_act)):
        np.testing.assert_allclose(tact(torch.from_numpy(z)).numpy(), np.asarray(jact(z)),
                                   rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_conv_mixer_block_train_statistics_match_jax(masked):
    """ConvMixerBlock in train mode: the output and every batch norm's new
    running statistics over the masked samples, rtol 1e-5; then eval mode."""
    r = np.random.default_rng(2)
    x = (r.normal(size=(10, 4, 4, 16)) * 2 + 0.5).astype(np.float32)  # NHWC
    mask = np.arange(10) % 4 != 3 if masked else None
    jblock = jax_layers.ConvMixerBlock(16)
    variables = jax.device_get(jblock.init(jax.random.PRNGKey(3), x))
    want, upd = jblock.apply(variables, x, True, None if mask is None else jnp.asarray(mask),
                             mutable=["batch_stats"])
    c = interop._Converter(variables["params"], variables["batch_stats"])
    for key, unit in (("dw.0", "dw1_conv"), ("dw.3", "dw2_conv"), ("pw.0", "pw_conv")):
        c.conv(key, unit, bias=True)
    for key, unit in (("dw.1", "dw1_bn"), ("dw.4", "dw2_bn"), ("pw.2", "pw_bn")):
        c.bn(key, unit)
    block = layers.ConvMixerBlock(16, device="cpu")
    block.load_state_dict(interop._finish(c), strict=True)
    tx = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad():
        got = block.train()(tx, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for key, unit in (("dw.1", "dw1_bn"), ("dw.4", "dw2_bn"), ("pw.2", "pw_bn")):
        for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(block.state_dict()[f"{key}.{name}"].numpy(),
                                       np.asarray(upd["batch_stats"][unit][leaf]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{key}.{name}")
    with torch.no_grad():
        got_eval = block.eval()(tx)
    want_eval = jblock.apply({"params": variables["params"], **upd}, x, False)
    np.testing.assert_allclose(np.moveaxis(got_eval.numpy(), 1, -1), np.asarray(want_eval),
                               rtol=1e-5, atol=1e-5)


def test_graphsage_block_isolated_spot_and_padding():
    """GraphSAGEBlock with a real spot without neighbours (its mean is 0, so
    its row is 0 after ReLU and the 1e-12 floor) and padded rows: the JAX
    block's output, and on the real rows the unpadded graph's."""
    r = np.random.default_rng(4)
    n, pad, f = 7, 3, 12
    x = r.normal(size=(n, f)).astype(np.float32)
    adj = (r.uniform(size=(n, n)) < 0.5).astype(np.float32)
    adj[3, :] = 0.0
    x_p = np.concatenate([x, r.normal(size=(pad, f)).astype(np.float32)])
    adj_p = np.zeros((n + pad, n + pad), np.float32)
    adj_p[:n, :n] = adj
    jblock = jax_layers.GraphSAGEBlock(10)
    params = jax.device_get(jblock.init(jax.random.PRNGKey(0), x, adj))["params"]
    block = layers.GraphSAGEBlock(f, 10, device="cpu")
    block.load_state_dict({"weight": torch.from_numpy(np.array(params["weight"]["kernel"]).T)})
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(adj))
        got_p = block(torch.from_numpy(x_p), torch.from_numpy(adj_p))
    np.testing.assert_allclose(got.numpy(), np.asarray(jblock.apply({"params": params}, x, adj)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(
        jblock.apply({"params": params}, x_p, adj_p)), rtol=1e-6, atol=1e-6)
    assert torch.equal(got[3], torch.zeros(10))
    np.testing.assert_allclose(got_p[:n].numpy(), got.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant, train):
    """The padded slide's three outputs (predictions, the ZINB or NB heads,
    h or, on an aug pass with the coef head, coef(h)) on every row; in train
    mode also the batch norms' new running stats."""
    jmodel, tmodel = _models(**VARIANTS[variant])
    jsecs, _ = _sections([21])
    batch = _padded(jsecs[0])
    variables = _variables(jmodel, batch)
    _carried(tmodel, variables)
    aug = variant == "coef"
    out = jmodel.apply(variables, *_args(batch), train=train, mask=batch["mask"], aug=aug,
                       mutable=["batch_stats"] if train else False)
    want, updates = out if train else (out, None)
    tmodel.train(train)
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, _args(batch)), mask=torch.from_numpy(batch["mask"]),
                     aug=aug)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FWD_TOL)
    assert len(got[1]) == len(want[1]) == (2 if variant == "nb" else 3)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)
    assert got[2].shape == ((batch["mask"].size, 1) if aug else (batch["mask"].size, 32))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **FWD_TOL)
    if train:
        sd = interop.baseline_params_from_jax(tmodel, variables["params"],
                                              jax.device_get(updates["batch_stats"]))
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 6
        for key in stats:
            np.testing.assert_allclose(tmodel.state_dict()[key].numpy(), sd[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_padded_slide_equals_unpadded_on_real_rows():
    """Train mode in the port: the padded slide with its mask gives the
    unpadded slide's outputs on its real rows and the same running stats."""
    _, tmodel = _models(coef_head=True)
    models.init_baseline_parameters(tmodel, torch.Generator().manual_seed(0))
    twin = _models(coef_head=True)[1]
    twin.load_state_dict(tmodel.state_dict())
    r = np.random.default_rng(3)
    n, pad = 11, 5
    patches = torch.from_numpy(r.uniform(size=(n, FIG, FIG, 3)).astype(np.float32))
    pos = torch.from_numpy(r.integers(0, 64, size=(n, 2)).astype(np.int32))
    adj = torch.from_numpy(trainer.knn_adjacency(pos.numpy(), k=3, prune="none"))
    p_adj = torch.zeros((n + pad, n + pad))
    p_adj[:n, :n] = adj
    mask = torch.arange(n + pad) < n
    with torch.no_grad():
        want = tmodel.train()(patches, pos, adj, aug=True)
        got = twin.train()(torch.cat([patches, torch.rand((pad, FIG, FIG, 3))]),
                           torch.cat([pos, torch.zeros((pad, 2), dtype=torch.int32)]), p_adj,
                           mask=mask, aug=True)
    for g, w in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        torch.testing.assert_close(g[:n], w, rtol=2e-4, atol=2e-5)
    for (key, a), b in zip(twin.state_dict().items(), tmodel.state_dict().values()):
        if key.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(a, b, rtol=5e-5, atol=1e-5, msg=key)


def _jax_bake_draws(key, n_bake):
    """The draws the JAX ``_bake_augment`` takes from ``key`` (per bake: gray,
    angle, flip from ``split(k, 3)``), computed jitted as the step does."""
    def draws(key):
        out = []
        for k in jax.random.split(key, n_bake):
            kg, kr, kf = jax.random.split(k, 3)
            out.append((jax.random.bernoulli(kg, 0.1),
                        jax.random.uniform(kr, (), minval=-90.0, maxval=90.0),
                        jax.random.bernoulli(kf, 0.2)))
        return out

    gray, angles, flip = zip(*jax.device_get(jax.jit(draws)(key)))
    return trainer.BakeDraws(tuple(map(bool, gray)), torch.tensor(np.array(angles, np.float32)),
                             tuple(map(bool, flip)))


def _near_ties(angle: float, size: int, window: float = 2.0**-14) -> np.ndarray:
    """(size, size) bool: output pixels whose exact (float64) source x or y
    lies within ``window`` of a .5 rounding tie, at ``angle`` degrees."""
    theta = np.float64(np.float32(angle)) * np.pi / 180.0
    c = (size - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(size) - c, np.arange(size) - c, indexing="ij")
    near = np.zeros((size, size), bool)
    for src in (np.cos(theta) * xx - np.sin(theta) * yy + c,
                np.sin(theta) * xx + np.cos(theta) * yy + c):
        near |= np.abs(src - np.floor(src) - 0.5) < window
    return near


def test_bake_matches_the_jitted_jax_bake():
    """``trainer.bake_patches`` on the draws of one JAX key against the
    jitted JAX ``_bake_augment`` (the Hist2ST step runs it jitted): 64 bakes
    of 2 images of 112 x 112 px. The grayscale and flip draws are JAX's, and
    both occur; the grayscale image within one float32 ulp of JAX's (XLA
    fuses its multiply-adds into FMAs; the port rounds once); the rotation
    bit-equal except at pixels whose exact (float64) source coordinate lies
    within 2**-14 of a .5 tie, where XLA's FMA and JAX's cos and sin may
    round the other way. At this key 192 of the 802,816 output pixels of the
    64 bakes lie that near a tie, and 1 of them differs; no other pixel
    does."""
    r = np.random.default_rng(7)
    size = 112  # the reference's figure size
    u8 = r.integers(0, 256, size=(2, size, size, 3), dtype=np.uint8)
    n_bake, key = 64, jax.random.PRNGKey(11)
    want = _jitted_bake(key, u8, n_bake)
    draws = _jax_bake_draws(key, n_bake)
    assert any(draws.gray) and any(draws.flip) and not all(draws.flip)
    patches = torch.from_numpy(u8).float() * torch.tensor(1.0 / 255.0)
    near_total = differing = 0
    for i in range(n_bake):
        got = trainer.bake_patches(patches, draws, i).numpy()
        near = _near_ties(float(draws.angles[i]), size)
        if draws.flip[i]:
            near = near[:, ::-1]
        tol = np.spacing(np.abs(want[i])) if draws.gray[i] else 0.0  # the luma: one ulp
        off = (np.abs(got - want[i]) > tol).any(axis=(0, 3))  # (P, P): off in either image
        assert not (off & ~near).any(), f"bake {i}: a pixel off away from a tie"
        if draws.gray[i]:
            assert np.array_equal(got[..., 0], got[..., 2]), f"bake {i}: gray channels"
        near_total += int(near.sum())
        differing += int(off.sum())
    assert (near_total, differing) == (192, 1), (near_total, differing)


# The coef head's gradients are differences of nearly equal bake predictions
# (a softmax across bakes that see nearly the same slide), which amplifies
# rounding: there the JAX package's fp32 gradients on the CPU lie up to 1.9e-4
# of the largest magnitude from a float64 evaluation of the port, while the
# port's fp32 ones stay within 3e-5 of it (``_fp64_grads``, held at 1e-4).
COEF, COEF_GRAD_TOL = ("coef.",), 1e-3


def _fp64_grads(model, cfg, batch, bakes, monkeypatch):
    """The slide loss's gradients from a float64 copy of ``model`` on the
    same padded slide and bakes."""
    twin = copy.deepcopy(model).double()
    with monkeypatch.context() as m:
        m.setattr(trainer.augment, "to_float", lambda u: u.double() / 255.0)
        b = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        trainer.slide_loss(twin, cfg, b, bakes=bakes.double()).backward()
    return {name: p.grad.float() for name, p in twin.named_parameters() if p.requires_grad}


def test_three_slide_steps_match_jax(monkeypatch):
    """make_slide_step at dropout 0 with zinb 0.25, bake 2 (the coef head)
    and lamb 0.5 on three padded slides, each step from the JAX trajectory's
    state (weights, batch-norm stats, Adam moments): the loss within rtol
    1e-4, the gradients against ``jax.grad`` of the JAX slide loss through
    all three passes (1e-4 of each tensor's largest magnitude; the coef
    head's 1e-3, see ``COEF``) and against a float64 evaluation of the port
    (1e-4, every tensor), each element's update against JAX's Adam step, and
    the running statistics chained through the three train-mode forwards.

    Both packages get the same baked patches: the JAX bakes of the step's
    key, computed by the jitted JAX ``_bake_augment`` and handed to the JAX
    loss in place of its own call and to the port's step through its
    ``bakes`` argument (the rotation rounds ties differently:
    ``test_bake_matches_the_jitted_jax_bake``)."""
    lr, n_bake = 1e-3, 2
    kw = _cfg(lr=lr, dropout=0.0, bake=n_bake, zinb_coef=0.25, lamb=0.5)
    jcfg, tcfg = jax_trainer.BaselineConfig(**kw), trainer.BaselineConfig(**kw)
    jmodel, tmodel = _models(coef_head=True)
    jsecs, tsecs = _sections([21, 13, 30])
    jbatches = [_padded(s) for s in jsecs]
    variables = _variables(jmodel, jbatches[0])
    tx = jax_trainer.baseline_optimizer(jcfg, steps_per_epoch=3)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    state = TrainState(_carried(tmodel, variables),
                       trainer.baseline_optimizer(tcfg, tmodel.parameters()))
    fixed = {"vit.transformer.jknet.0.bias_hh_l0", "vit.transformer.jknet.0.bias_hh_l1"}
    assert fixed <= {name for name, _ in tmodel.named_buffers()}
    assert not fixed & {name for name, _ in tmodel.named_parameters()}
    assert all(p.requires_grad for p in tmodel.parameters())
    step = trainer.make_slide_step(tcfg, steps_per_epoch=3)
    held = {}
    monkeypatch.setattr(jax_trainer, "_bake_augment", lambda key, patches, n: held["baked"])

    def loss_fn(params, stats, batch, rng):
        held["baked"] = batch.pop("baked")
        return jax_trainer._slide_loss(jmodel, jcfg, params, stats, batch, rng)

    jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for i, (jb, ts) in enumerate(zip(jbatches, tsecs)):
        if i:
            _sync_from_jax(state, jstate)
        rng = jax.random.PRNGKey(i)
        baked = _jitted_bake(jax.random.split(rng)[1], jb["patches"], n_bake)
        jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
        (jloss, new_bs), jgrads = jgrad(jstate.params, jstate.batch_stats,
                                        {**jbatch, "baked": baked}, rng)
        want_grads = interop.baseline_params_from_jax(tmodel, jax.device_get(jgrads),
                                                      jax.device_get(jstate.batch_stats))
        jstate = jstate.apply_gradients(jgrads, new_bs)
        before = {k: v.clone() for k, v in tmodel.state_dict().items()}
        batch = trainer.slide_tensors(trainer.pad_slide(ts, BUCKET, True, tcfg), "cpu")
        bakes = torch.from_numpy(baked)
        exact = _fp64_grads(tmodel, tcfg, batch, bakes, monkeypatch)
        loss = step(state, batch, torch.Generator().manual_seed(i), bakes=bakes)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        want_after = interop.baseline_params_from_jax(tmodel, jax.device_get(jstate.params),
                                                      jax.device_get(jstate.batch_stats))
        grads = {name: p.grad for name, p in tmodel.named_parameters()}
        _assert_step_matches(tmodel, before, grads, want_grads, want_after, lr, i,
                             near_zero=NEAR_ZERO, loose=COEF, loose_tol=COEF_GRAD_TOL)
        for name, e in exact.items():
            if name not in NEAR_ZERO:
                e = e.numpy()
                np.testing.assert_allclose(grads[name].numpy(), e, rtol=0,
                                           atol=1e-4 * np.abs(e).max(),
                                           err_msg=f"step {i}: float64 {name}")
    assert state.step == 3


class _Weight(torch.nn.Module):
    """A stand-in model: one parameter, whose gradient the fake loss makes 1."""

    coef_head = False

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4))


def test_steplr_lr_at_every_step(monkeypatch):
    """Hist2ST's StepLR stepped per epoch, lr_step_epochs 1 and gamma 0.5 over
    3 epochs of 3 slides: ``train_baseline_fold`` passes len(training
    sections) as steps_per_epoch, and each step's update with a constant
    gradient of 1 (an Adam step of lr / (1 + eps)) equals the JAX optimizer's
    update under its schedule, rtol 5e-5 (optax corrects the moments' bias
    in float32, torch in double: 1e-5 apart at the first step); the lr
    halves at steps 3 and 6."""
    kw = _cfg(lr=1e-3, max_epochs=3, lr_step_epochs=1, lr_gamma=0.5)
    jcfg, tcfg = jax_trainer.BaselineConfig(**kw), trainer.BaselineConfig(**kw)
    tx = jax_trainer.baseline_optimizer(jcfg, steps_per_epoch=3)
    params = {"w": jnp.zeros(4)}
    opt, want = tx.init(params), []
    for _ in range(9):
        updates, opt = tx.update({"w": jnp.ones(4)}, opt, params)
        want.append(-float(updates["w"][0]))
    model = _Weight()
    seen = []

    def fake_loss(model, cfg, batch, generator=None, bakes=None):
        seen.append(float(model.w[0]))
        return model.w.sum()

    monkeypatch.setattr(trainer, "init_baseline", lambda cfg, device, attn_backend: TrainState(
        model, trainer.baseline_optimizer(cfg, model.parameters())))
    monkeypatch.setattr(trainer, "slide_loss", fake_loss)
    _, tsecs = _sections([9, 12, 10, 11])
    state = trainer.train_baseline_fold(tcfg, tsecs, 0, device="cpu")
    assert state.step == 9 and len(seen) == 9
    got = -np.diff(seen + [float(model.w[0])])
    np.testing.assert_allclose(got, want, rtol=5e-5)
    assert np.allclose(want[3], want[2] / 2, rtol=5e-5) and np.allclose(want[6], want[5] / 2,
                                                                       rtol=5e-5)
    assert [trainer.baseline_lr(tcfg, k, 3) for k in (2, 3, 6)] == [1e-3, 5e-4, 2.5e-4]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dict_imports_back_into_jax(variant):
    """The port's state_dict (reference torch keys, the LSTM's bias in
    bias_ih) through the JAX package's ``IMPORTERS["hist2st"]`` gives back
    the flax tree exactly, batch stats included."""
    jmodel, tmodel = _models(**VARIANTS[variant])
    jsecs, _ = _sections([16])
    variables = _variables(jmodel, _padded(jsecs[0]))
    _carried(tmodel, variables)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert "vit.transformer.jknet.0.weight_hh_l1" in sd and ("coef.2.weight" in sd) == (
        variant == "coef")
    params, stats = jax_import.IMPORTERS["hist2st"](sd, jmodel)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for got, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key


def test_predict_and_evaluate_match_jax():
    """predict_slide (Hist2ST's first output, eval mode, the running stats
    moved by one train-mode pass) and evaluate_baseline_fold's metrics
    against the JAX functions."""
    jmodel, tmodel = _models(coef_head=True)
    jsecs, tsecs = _sections([21, 13], seed=2)
    cfg_kw = _cfg()
    jcfg, tcfg = jax_trainer.BaselineConfig(**cfg_kw), trainer.BaselineConfig(**cfg_kw)
    batch = _padded(jsecs[0])
    variables = _variables(jmodel, batch)
    _, upd = jmodel.apply(variables, *_args(batch), train=True, mask=batch["mask"],
                          mutable=["batch_stats"])
    variables = {"params": variables["params"], **jax.device_get(upd)}
    jstate = JaxTrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=None, tx=None)
    _carried(tmodel, variables)
    for js, ts in zip(jsecs, tsecs):
        got = trainer.predict_slide(tmodel, ts, tcfg)
        assert got.shape == (ts.num_spots, G)
        np.testing.assert_allclose(got, jax_trainer.predict_slide(jmodel, jstate, js, jcfg),
                                   **FWD_TOL)
    want = jax_trainer.evaluate_baseline_fold(jcfg, jsecs, 1, jmodel, jstate)
    got = trainer.evaluate_baseline_fold(tcfg, tsecs, 1, tmodel)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)


def _std_within(w, std, rel=0.1):
    got = float(np.asarray(w, np.float64).std())
    assert abs(got - std) <= rel * std, (got, std)


def test_init_families_by_their_statistics():
    """init_baseline_parameters draws Hist2ST's tensors from the JAX
    modules' families, checked by their statistics at 64 channels (dim 128)
    beside the JAX init's: the convs lecun-normal (std sqrt(1 / fan_in),
    truncated at 2 std; a depthwise 5 x 5 has fan_in 25) with zero biases,
    GraphSAGE xavier-uniform, the LSTM's input kernels lecun-normal, each
    gate's recurrent kernel orthogonal, its biases zero."""
    kw = dict(WIDTHS, channel=64)
    tmodel = models.Hist2ST(G, device="cpu", coef_head=True, **kw)
    models.init_baseline_parameters(tmodel, torch.Generator().manual_seed(0))
    jmodel = jax_models.Hist2ST(n_genes=G, coef_head=True, **kw)
    r = np.random.default_rng(0)
    n = 5
    jvars = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), r.uniform(size=(n, FIG, FIG, 3)).astype(np.float32),
        np.zeros((n, 2), np.int32), np.eye(n, dtype=np.float32), aug=True))["params"]
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    t = "vit.transformer"
    convs = {"patch_embedding": ("patch_embedding",), f"{t}.down.0": ("down",),
             f"{t}.layer1.0.dw.0": ("mixer0", "dw1_conv"),
             f"{t}.layer1.0.dw.3": ("mixer0", "dw2_conv"),
             f"{t}.layer1.0.pw.0": ("mixer0", "pw_conv")}
    for key, path in convs.items():
        w = sd[f"{key}.weight"]
        std = (1.0 / w[0].size) ** 0.5
        # N(0, (std / 0.8796)^2) cut at 2 of its std: a unit normal cut at 2 has std 0.8796
        assert np.abs(w).max() <= 2 * std / 0.87962566 * 1.0001, key
        _std_within(w, std, 0.15)
        jw = jvars
        for p in path:
            jw = jw[p]
        _std_within(jw["kernel"], std, 0.15)
        assert not sd[f"{key}.bias"].any() and not np.asarray(jw["bias"]).any(), key
    bound = (6.0 / (128 + 128)) ** 0.5
    for i in range(2):
        w = sd[f"{t}.layer3.{i}.weight"]
        assert np.abs(w).max() <= bound
        _std_within(w, bound / 3**0.5, 0.05)
        _std_within(jvars[f"gs{i}"]["weight"]["kernel"], bound / 3**0.5, 0.05)
    lstm = f"{t}.jknet.0"
    for layer, cell in enumerate(("jknet_cell", "jknet2_cell")):
        w_ih = sd[f"{lstm}.weight_ih_l{layer}"]
        assert np.abs(w_ih).max() <= 2 / 0.87962566 / 128**0.5 * 1.0001
        _std_within(w_ih, 128**-0.5, 0.05)
        _std_within(jvars[cell]["ii"]["kernel"], 128**-0.5, 0.1)
        gates = np.split(sd[f"{lstm}.weight_hh_l{layer}"], 4)
        for gate, name in zip(gates, ("hi", "hf", "hg", "ho")):
            np.testing.assert_allclose(gate @ gate.T, np.eye(128), atol=1e-5)
            jk = np.asarray(jvars[cell][name]["kernel"])
            np.testing.assert_allclose(jk @ jk.T, np.eye(128), atol=1e-5)
            assert not np.asarray(jvars[cell][name]["bias"]).any()
        assert not sd[f"{lstm}.bias_ih_l{layer}"].any() and not sd[f"{lstm}.bias_hh_l{layer}"].any()
    head = sd["gene_head.1.weight"]
    assert np.abs(head).max() <= 128**-0.5 and not np.array_equal(head, np.zeros_like(head))
