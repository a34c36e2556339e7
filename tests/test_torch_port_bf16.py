"""The port's bfloat16 path (``dtype="bfloat16"``) against the JAX modules in bf16.

The JAX rule, followed by the port with explicit casts: parameters fp32,
compute in bf16, embeddings and losses fp32. XLA and torch round bf16 at
other places (fused ops, sum orders, where a constant is rounded), so a
bf16 output is not held bit for bit. Each port output y is held to the JAX
module's bf16 output with the JAX fp32 output as the anchor:

    max|y_port - y_jax| <= 2 max|y_jax - y_jax32| + 2**-8 max|y_jax32|

(twice the JAX module's own bf16 error, plus half a bf16 ulp of the
largest value), and y_port must differ from the port's fp32 output, so a
path that quietly stays in fp32 fails. Inputs are made by numpy from a
seed; weights are carried from the JAX variables (``interop``). Data
movement is held exact: the bf16 uint8 scale over all 256 values and the
Paeth rotation of bf16 images. ``color_jitter`` in bf16 is held within one
bf16 ulp: XLA rounds after every operation of the jitter as torch does
(the luma weights rounded to bf16 first on both sides) except in the
contrast op, where it keeps the gray image's last add in fp32 before the
fp32 mean (the port does the same, ``augment._luma_cm``); that mean's fp32
sum runs in another order on each side, which can move the mean, and then
a blend, by one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_augment import _every_uint8, _jax_st_draws, _shears_agree

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.baselines import models as jax_models
from mclstexp_tpu.core import layers as jax_layers
from mclstexp_tpu.core.losses import symmetric_infonce as jax_infonce
from mclstexp_tpu.models import spot as jax_spot
from mclstexp_tpu.models.image import densenet as jax_densenet
from mclstexp_tpu.models.image import resnet as jax_resnet
from mclstexp_tpu.models.mclstexp import MclSTExp as JaxMclSTExp
from mclstexp_tpu.ops import augment as jax_augment
from mclstexp_tpu_torch import config, interop
from mclstexp_tpu_torch.baselines import models, trainer
from mclstexp_tpu_torch.core import layers
from mclstexp_tpu_torch.core.losses import symmetric_infonce
from mclstexp_tpu_torch.models.image.densenet import densenet121
from mclstexp_tpu_torch.models.image.resnet import resnet50
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.models.spot import SpotEncoder
from mclstexp_tpu_torch.ops import augment

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _anchored(got, want, want32, got32, name=""):
    """The anchored bf16 rule of the module docstring, and got != got32."""
    got, want, want32, got32 = map(_np, (got, want, want32, got32))
    bound = 2 * np.abs(want - want32).max() + 2.0**-8 * np.abs(want32).max()
    err = np.abs(got - want).max()
    assert err <= bound, (name, err, bound)
    assert not np.array_equal(got, got32), f"{name}: the bf16 path gave the fp32 answer"


def _init(jmodule, *args):
    return jax.device_get(jmodule.init(jax.random.PRNGKey(0), *args))


def _module_case(make_jax, make_port, load, x, cast_input=False):
    """Run the JAX module in bf16 and fp32 and the port's in bf16 and fp32
    on numpy input ``x`` (``cast_input``: the bf16 modules take it in bf16,
    as the spot tower hands its blocks) and apply the rule."""
    jbf, j32 = make_jax(jnp.bfloat16), make_jax(jnp.float32)
    variables = _init(j32, x)
    want = jbf.apply(variables, jnp.asarray(x).astype(jnp.bfloat16) if cast_input else x)
    want32 = j32.apply(variables, x)
    outs = []
    for dtype in (BF16, torch.float32):
        m = make_port()
        load(m, variables)
        layers.set_compute_dtype(m, dtype)
        t = torch.from_numpy(x)
        with torch.no_grad():
            outs.append(m(t.to(dtype) if cast_input else t))
    assert outs[0].dtype == BF16
    _anchored(outs[0], want, want32, outs[1])


def _converter(variables):
    return interop._Converter(variables["params"], variables.get("batch_stats", {}))


def _load(build):
    """A loader: ``build(converter)`` writes the module's keys."""
    def load(module, variables):
        c = _converter(variables)
        build(c)
        module.load_state_dict({k.lstrip("."): v for k, v in interop._finish(c).items()},
                               strict=True)
    return load


def test_dense_bf16_matches_jax(rng):
    x = rng.normal(size=(6, 40)).astype(np.float32)
    _module_case(lambda dt: jax_layers.DenseT(24, dtype=dt),
                 lambda: layers.DenseT(40, 24),
                 _load(lambda c: c.linear("")), x)


def test_layer_norm_bf16_matches_jax(rng):
    x = (3.0 + rng.normal(size=(6, 40))).astype(np.float32)
    _module_case(lambda dt: jax_layers.LayerNormT(dtype=dt), lambda: layers.LayerNormT(40),
                 _load(lambda c: c.ln("")), x)


def test_attn_block_bf16_matches_jax(rng):
    """A spot block on a bf16 input (the spot tower casts before its
    blocks), the "xla" attention: fp32 logits and softmax, bf16 product."""
    x = rng.normal(size=(1, 20, 24)).astype(np.float32)
    _module_case(lambda dt: jax_layers.AttnBlock(24, 2, 16, 24, dtype=dt),
                 lambda: layers.AttnBlock(24, 2, 16, 24),
                 _load(lambda c: interop._attn_block(c, "")), x, cast_input=True)


def test_projection_head_bf16_matches_jax(rng):
    x = rng.normal(size=(8, 40)).astype(np.float32)

    def build(c):
        c.linear("projection", "projection")
        c.linear("fc", "fc")
        c.ln("layer_norm", "layer_norm")

    _module_case(lambda dt: jax_layers.ProjectionHead(16, dtype=dt),
                 lambda: layers.ProjectionHead(40, 16), _load(build), x)


def test_spot_encoder_bf16_matches_jax(rng):
    """The spot tower (expression + position tables, cast to bf16, two
    blocks with the "xla" attention, which the JAX module runs off a TPU)."""
    expr = rng.normal(size=(12, 24)).astype(np.float32)
    pos = rng.integers(0, 32, size=(12, 2)).astype(np.int32)
    mods = {dt: jax_spot.SpotEncoder(24, 2, 16, 2, pos_vocab=32, dtype=dt)
            for dt in (jnp.bfloat16, jnp.float32)}
    variables = _init(mods[jnp.float32], expr, pos)
    want, want32 = (mods[dt].apply(variables, expr, pos) for dt in (jnp.bfloat16, jnp.float32))
    outs = []
    for dtype in (BF16, torch.float32):
        c = _converter({"params": {"spot_encoder": variables["params"]}})
        for i in range(2):
            interop._attn_block(c, f"{i}", "spot_encoder", f"block{i}")
        tables = layers.PositionTables(32, 24)
        tables.load_state_dict({"x_embed.weight": torch.from_numpy(np.array(
            variables["params"]["pos"]["x_embed"])), "y_embed.weight": torch.from_numpy(
            np.array(variables["params"]["pos"]["y_embed"]))})
        c.consumed |= {(False, ("spot_encoder", "pos", k)) for k in ("x_embed", "y_embed")}
        enc = SpotEncoder(24, 2, 16, 2)
        enc.load_state_dict(interop._finish(c), strict=True)
        layers.set_compute_dtype(enc, dtype)
        with torch.no_grad():
            feats = torch.from_numpy(expr) + tables.position_embed(torch.from_numpy(pos))
            outs.append(enc(feats))
    assert outs[0].dtype == BF16
    _anchored(outs[0], want, want32, outs[1])


@pytest.fixture(scope="module")
def densenet_case():
    """densenet121 at 64 px, batch 4: the JAX tower's outputs in bf16 and
    fp32, eval and train mode (with the new running stats), and its
    variables.

    The bf16 program is compiled with ``xla_allow_excess_precision`` off.
    With it on (the default), XLA on the CPU runs each bf16 convolution in
    fp32 and hands the following batch norm the unrounded fp32 output for
    its statistics and its normalization, so the JAX module is more precise
    there than its own types say (``nn.Conv(dtype=bf16)``: a bf16 output);
    the port rounds the convolution's output to bf16 as the type says, and
    deep in the tower the running statistics then drift from the CPU
    program's by up to 1.5 times the anchored bound. Off, XLA rounds where
    the module's types round."""
    x = np.random.default_rng(5).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    mods = {dt: jax_densenet.densenet121(dtype=dt) for dt in (jnp.bfloat16, jnp.float32)}
    variables = jax.device_get(jax.jit(
        lambda k: mods[jnp.float32].init(k, x[:1], train=False))(jax.random.PRNGKey(0)))
    out = {}
    for dt, mod in mods.items():  # one program per dtype: eval, then train
        both = jax.jit(lambda v, m=mod: (m.apply(v, x, train=False),
                                         m.apply(v, x, train=True, mutable=["batch_stats"])))
        options = {"xla_allow_excess_precision": False} if dt == jnp.bfloat16 else {}
        out[dt, False], out[dt, True] = jax.device_get(
            both.lower(variables).compile(options)(variables))
    return x, variables, out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_densenet121_bf16_matches_jax(densenet_case, train):
    """The tower's fp32 features (bf16 inside), and in train mode its fp32
    running statistics, each within the rule."""
    x, variables, out = densenet_case
    sd = interop.tower_params_from_jax(variables["params"], variables["batch_stats"],
                                       "densenet121")
    got = {}
    for dtype in (BF16, torch.float32):
        tower = layers.set_compute_dtype(densenet121(device="cpu"), dtype)
        tower.load_state_dict(sd, strict=True)
        tower.train(train)
        with torch.no_grad():
            got[dtype] = tower(torch.from_numpy(x)), tower.state_dict()
    if not train:
        assert got[BF16][0].dtype == torch.float32
        _anchored(got[BF16][0], out[jnp.bfloat16, False], out[jnp.float32, False],
                  got[torch.float32][0], "features")
        return
    (want, upd), (want32, upd32) = out[jnp.bfloat16, True], out[jnp.float32, True]
    _anchored(got[BF16][0], want, want32, got[torch.float32][0], "features")
    new = {dt: interop.tower_params_from_jax(variables["params"], u["batch_stats"],
                                             "densenet121") for dt, u in ((BF16, upd),
                                                                          (torch.float32, upd32))}
    stats = [k for k in new[BF16] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 121  # norm0, 2 x 58 dense layers, 3 transitions, norm5
    for key in stats:
        assert got[BF16][1][key].dtype == torch.float32
        _anchored(got[BF16][1][key], new[BF16][key], new[torch.float32][key],
                  got[torch.float32][1][key], key)


@pytest.fixture(scope="module")
def resnet50_case():
    """resnet50 (BLEEP's default tower) at 64 px, batch 4: the JAX tower's
    outputs in bf16 and fp32, eval and train mode (with the new running
    stats), and its variables; the bf16 program compiled with
    ``xla_allow_excess_precision`` off, for the reason ``densenet_case``
    gives."""
    x = np.random.default_rng(6).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    mods = {dt: jax_resnet.resnet50(dtype=dt) for dt in (jnp.bfloat16, jnp.float32)}
    variables = jax.device_get(jax.jit(
        lambda k: mods[jnp.float32].init(k, x[:1], train=False))(jax.random.PRNGKey(1)))
    out = {}
    for dt, mod in mods.items():
        both = jax.jit(lambda v, m=mod: (m.apply(v, x, train=False),
                                         m.apply(v, x, train=True, mutable=["batch_stats"])))
        options = {"xla_allow_excess_precision": False} if dt == jnp.bfloat16 else {}
        out[dt, False], out[dt, True] = jax.device_get(
            both.lower(variables).compile(options)(variables))
    return x, variables, out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet50_bf16_matches_jax(resnet50_case, train):
    """resnet50's fp32 features (bf16 inside), and in train mode its 53
    batch norms' fp32 running statistics, each within the rule."""
    x, variables, out = resnet50_case
    sd = interop.tower_params_from_jax(variables["params"], variables["batch_stats"], "resnet50")
    got = {}
    for dtype in (BF16, torch.float32):
        tower = layers.set_compute_dtype(resnet50(device="cpu"), dtype)
        tower.load_state_dict(sd, strict=True)
        tower.train(train)
        with torch.no_grad():
            got[dtype] = tower(torch.from_numpy(x)), tower.state_dict()
    assert got[BF16][0].dtype == torch.float32
    (want, upd), (want32, upd32) = ((out[jnp.bfloat16, True], out[jnp.float32, True]) if train
                                    else ((out[jnp.bfloat16, False], None),
                                          (out[jnp.float32, False], None)))
    _anchored(got[BF16][0], want, want32, got[torch.float32][0], "features")
    if not train:
        return
    new = {dt: interop.tower_params_from_jax(variables["params"], u["batch_stats"], "resnet50")
           for dt, u in ((BF16, upd), (torch.float32, upd32))}
    stats = [k for k in new[BF16] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 53  # the stem, 16 blocks of 3, 4 downsamples
    for key in stats:
        assert got[BF16][1][key].dtype == torch.float32
        _anchored(got[BF16][1][key], new[BF16][key], new[torch.float32][key],
                  got[torch.float32][1][key], key)


TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, pos_vocab=64, dense_block_impl="concat")


def test_train_step_loss_and_gradients_bf16_match_jax():
    """One step's InfoNCE loss and every parameter gradient of the bf16
    model, from uint8 patches through the bf16 "st" augmentation with the
    JAX key's draws (the images bit-equal), against jax.grad of the JAX
    bf16 model; the anchor is the fp32 step."""
    r = np.random.default_rng(11)
    patches = r.integers(0, 256, size=(8, 16, 16, 3), dtype=np.uint8)
    expr = r.normal(size=(8, 24)).astype(np.float32)
    pos = r.integers(0, 64, size=(8, 2)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    draws = _jax_st_draws(key, 8)
    assert _shears_agree(jnp.asarray(draws.angles.numpy()))
    grads, losses, images = {}, {}, {}
    for name, jdt in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
        jm = JaxMclSTExp(jax_config.ModelConfig(**{**TINY, "dtype": name}))
        imgs = jax_augment.train_augment_inline(key, jnp.asarray(patches), dtype=jdt,
                                                rot_impl="paeth")
        batch = {"image": imgs, "expression": expr, "position": pos}
        if name == "bfloat16":
            variables = jax.device_get(jm.init(jax.random.PRNGKey(0), batch, train=False))

        def loss_fn(p, jm=jm, batch=batch):
            (ie, se), _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                   batch, train=True, mutable=["batch_stats"])
            return jax_infonce(se, ie, 1.0)

        losses[name], grads[name] = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
        images[name] = np.asarray(imgs.astype(jnp.float32))
    jcfg = config.ModelConfig(**{**TINY, "dtype": "float32"})
    want_grads = {n: interop.params_from_jax(g, variables["batch_stats"], jcfg)
                  for n, g in grads.items()}
    got_loss, got_grads = {}, {}
    for name in ("bfloat16", "float32"):
        cfg = config.ModelConfig(**{**TINY, "dtype": name})
        tm = MclSTExp(cfg, device="cpu")
        tm.load_state_dict(interop.params_from_jax(variables["params"],
                                                   variables["batch_stats"], cfg), strict=True)
        dtype = layers.compute_dtype_of(name)
        imgs = augment.train_augment_inline(torch.from_numpy(patches), draws, dtype=dtype)
        assert imgs.dtype == dtype
        # the jitter's gray mean may round one ulp apart (test_color_jitter_bf16_*)
        np.testing.assert_allclose(imgs.float().numpy(), images[name], rtol=0,
                                   atol=2.0**-8 if dtype == BF16 else 1e-6)
        tm.train()
        ie, se = tm({"image": imgs, "expression": torch.from_numpy(expr),
                     "position": torch.from_numpy(pos)})
        assert ie.dtype == se.dtype == torch.float32
        loss = symmetric_infonce(se, ie, 1.0)
        loss.backward()
        got_loss[name] = loss.detach()
        got_grads[name] = {k: p.grad for k, p in tm.named_parameters()}
    _anchored(got_loss["bfloat16"], losses["bfloat16"], losses["float32"],
              got_loss["float32"], "loss")
    for k, g in got_grads["bfloat16"].items():
        assert g.dtype == torch.float32, k
        _anchored(g, want_grads["bfloat16"][k], want_grads["float32"][k],
                  got_grads["float32"][k], k)


@pytest.mark.parametrize("family", ["histogene", "thitogene", "hist2st"])
def test_slide_baselines_bf16_match_jax(family):
    """HisToGene, THItoGene and Hist2ST on a padded slide in train mode
    (masked batch norms): the predictions and the masked MSE of the real
    rows (Hist2ST: its first output, through the bf16 mixers, attention and
    GraphSAGE products, the fp32 neighbour mean and LSTM)."""
    r = np.random.default_rng(3)
    patch = {"histogene": 16, "thitogene": 112, "hist2st": 28}[family]
    n, real, genes = 16, 13, 8
    patches = r.uniform(size=(n, patch, patch, 3)).astype(np.float32)
    positions = r.integers(0, 16, size=(n, 2)).astype(np.int32)
    adj = (r.uniform(size=(n, n)) < 0.3).astype(np.float32)
    target = r.normal(size=(n, genes)).astype(np.float32)
    mask = np.arange(n) < real
    args = (patches, positions) + ((adj,) if family != "histogene" else ())
    hist2st = dict(fig_size=28, patch_size=7, channel=16, depth1=1, depth2=1, depth3=2, heads=2,
                   dropout=0.0)

    def jax_model(dt):
        if family == "histogene":
            return jax_models.HisToGene(n_genes=genes, patch_size=16, dim=32, n_layers=2,
                                        heads=2, dropout=0.0, dtype=dt)
        if family == "hist2st":
            return jax_models.Hist2ST(n_genes=genes, dtype=dt, **hist2st)
        return jax_models.THItoGene(n_genes=genes, patch_size=112, dim=32, n_layers=1, caps=4,
                                    route_dim=8, heads=(2, 2), dropout=0.0, dtype=dt)

    def port_model(dt):
        if family == "histogene":
            return models.HisToGene(genes, 16, dim=32, n_layers=2, heads=2, dropout=0.0,
                                    dtype=dt, device="cpu")
        if family == "hist2st":
            return models.Hist2ST(genes, dtype=dt, device="cpu", **hist2st)
        return models.THItoGene(genes, 112, dim=32, n_layers=1, caps=4, route_dim=8,
                                heads=(2, 2), dropout=0.0, dtype=dt, device="cpu")

    first = (lambda out: out[0]) if family == "hist2st" else (lambda out: out)
    variables = _init(jax_model(jnp.float32), *args)
    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out, _ = jax_model(dt).apply(variables, *args, train=True, mask=mask,
                                     mutable=["batch_stats"])
        want[dt] = (first(out), trainer_loss_jax(first(out), target, mask))
    got = {}
    for name in ("bfloat16", "float32"):
        tm = port_model(name)
        tm.load_state_dict(interop.baseline_params_from_jax(
            tm, variables["params"], variables.get("batch_stats", {})), strict=True)
        tm.train()
        with torch.no_grad():
            pred = first(tm(*map(torch.from_numpy, args), mask=torch.from_numpy(mask)))
        assert pred.dtype == torch.float32
        got[name] = (pred, trainer.masked_mse(pred, torch.from_numpy(target),
                                              torch.from_numpy(mask).float()))
    for i, what in enumerate(("pred", "loss")):
        _anchored(got["bfloat16"][i], want[jnp.bfloat16][i], want[jnp.float32][i],
                  got["float32"][i], what)


def trainer_loss_jax(pred, target, mask):
    from mclstexp_tpu.baselines.trainer import masked_mse

    return masked_mse(pred, jnp.asarray(target), jnp.asarray(mask, jnp.float32))


def test_uint8_scale_bf16_bit_equal_to_the_jitted_jax_step(monkeypatch):
    """The bf16 images that reach the jitter equal, for all 256 uint8
    values, the JAX step's jitted ``(u.astype(bf16) / bf16(255)).astype(
    bf16)`` (XLA: a float32 multiply by float32(1/255), one rounding)."""
    u = _every_uint8((2, 16, 16, 3))
    want = np.asarray(jax.jit(lambda x: (x.astype(jnp.bfloat16) / jnp.asarray(
        255.0, jnp.bfloat16)).astype(jnp.bfloat16))(jnp.asarray(u))).view(np.uint16)
    seen = []

    def jitter(imgs, factors, order):
        seen.append(imgs.clone())
        return imgs

    monkeypatch.setattr(augment, "color_jitter", jitter)
    draws = augment.sample_st_draws(torch.Generator().manual_seed(0), 2, "cpu")
    augment.train_augment_inline(torch.from_numpy(u), draws, dtype=BF16)
    assert len(seen) == 1 and seen[0].dtype == BF16
    np.testing.assert_array_equal(seen[0].view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("with_flip", [False, True])
def test_paeth_rotation_bf16_bit_equal_to_jax(rng, with_flip):
    imgs = rng.uniform(size=(6, 16, 16, 3)).astype(np.float32)
    angles = np.concatenate([[0.0, 90.0, -135.0], rng.uniform(-180, 180, size=3)]).astype(
        np.float32)
    hflip = np.array([True, False, True, True, False, True]) if with_flip else None
    assert _shears_agree(jnp.asarray(angles))
    jimgs = jnp.asarray(imgs).astype(jnp.bfloat16)
    want = jax_augment.rotate_batch_paeth(
        jimgs, jnp.asarray(angles), hflip=None if hflip is None else jnp.asarray(hflip),
        interpret=True)
    assert want.dtype == jnp.bfloat16
    got = augment.rotate_batch_paeth(torch.from_numpy(imgs).to(BF16), torch.from_numpy(angles),
                                     hflip=None if hflip is None else torch.from_numpy(hflip))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_color_jitter_bf16_within_one_ulp_of_jax():
    """The JAX step's per-image jitter (vmapped, jitted) on bf16 images
    against the port's for the same factors and orders; within one bf16 ulp
    of each value (module docstring), and on most values exact."""
    r = np.random.default_rng(2)
    b = 24
    u = r.integers(0, 256, size=(b, 16, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, b)
    imgs = (jnp.asarray(u).astype(jnp.bfloat16) / jnp.asarray(255.0, jnp.bfloat16)).astype(
        jnp.bfloat16)
    want = np.asarray(jax.jit(jax.vmap(jax_augment.color_jitter))(keys, imgs).astype(
        jnp.float32))
    jit, order = [], []
    for k in keys:
        k_perm, k_b, k_c, k_s = jax.random.split(k, 4)
        jit.append([float(jax.random.uniform(kk, (), minval=0.5, maxval=1.5))
                    for kk in (k_b, k_c, k_s)])
        order.append(int(jax.random.randint(k_perm, (), 0, 6)))
    assert set(order) == set(range(6))  # every op order
    timgs = augment.to_float(torch.from_numpy(u)).to(BF16)
    got = augment.color_jitter(timgs, torch.tensor(np.asarray(jit, np.float32)),
                               torch.tensor(order))
    assert got.dtype == BF16
    got = got.float().numpy()
    big = np.maximum(np.maximum(np.abs(want), np.abs(got)), 2.0**-126)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.99
    got32 = augment.color_jitter(timgs.float(), torch.tensor(np.asarray(jit, np.float32)),
                                 torch.tensor(order)).numpy()
    assert not np.array_equal(got, got32)
