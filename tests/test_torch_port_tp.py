"""The port's tensor-parallel layouts (``parallel/tp.py``) against the JAX
package's rules and the replicated step, on the CPU.

The rules: ``tp_param_placements`` equals JAX's ``tp_param_specs`` leaf for
leaf, for the tiny flagship, a ViT tower and the uneven config of
``tests/test_tp.py`` (spot_dim 15, heads_dim 3). The name map is
``interop.params_from_jax``'s: each JAX leaf goes in as its elements'
global indices, so the port's tensor of the same name says which leaf it
came from and which of its dims each JAX dim became (a dense kernel's
(in, out) is a torch weight's (out, in)); a JAX spec sharded on dim j is
``Shard`` of the torch dim that JAX dim j became.

One gloo job at world size 2 (a (1, 2) ("data", "model") mesh) and one at
4 ((2, 2)), every rank a process started once for this module
(``tests/_torch_port_gloo.py::run_tp``): the placements ``shard_params``
gives and the local shard shapes (the uneven config's against JAX's
``shard_params`` on a (4, 2) mesh: replicated where the axis does not
divide the dim), and one flagship step (augment "none") with tiny_cnn and
with tiny_densenet (batch norms) after ``shard_train_state``, against the
one-process step on the global batch: the loss rtol 2e-5, every parameter
and running statistic after Adam rtol 2e-5 / atol 2e-6 (the tolerances of
``tests/test_tp.py``), and the gradients before Adam within 1e-5 of each
tensor's largest magnitude (or, where the one-process float32 gradient is
itself ill-conditioned, against a float64 evaluation); every rank the same
bits. The step's
checkpoint (``save_checkpoint_on_lead``) holds whole tensors and loads into
a one-process model.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from mclstexp_tpu.config import ModelConfig as JaxModelConfig
from mclstexp_tpu.config import TrainConfig as JaxTrainConfig
from mclstexp_tpu.models.image import vit as jax_vit
from mclstexp_tpu.parallel import tp as jax_tp
from mclstexp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mclstexp_tpu.train.state import create_train_state as jax_create_train_state
from mclstexp_tpu_torch.config import ModelConfig, TrainConfig
from mclstexp_tpu_torch.interop import params_from_jax, tower_params_from_jax
from mclstexp_tpu_torch.models.image import vit
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.parallel import tp
from mclstexp_tpu_torch.train import checkpoint
from mclstexp_tpu_torch.train.state import create_train_state
from _torch_port_gloo import step_outcome

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLDS = (2, 4)  # (1, 2) and (2, 2) ("data", "model") meshes
TINY = dict(encoder_name="tiny_cnn", image_dim=128, spot_dim=16, projection_dim=8,
            heads_num=2, heads_dim=4, head_layers=1, pos_vocab=64)
DENSENET = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=16, projection_dim=8,
                heads_num=2, heads_dim=4, head_layers=1, pos_vocab=64,
                dense_block_impl="concat")
UNEVEN = dict(encoder_name="tiny_cnn", image_dim=128, spot_dim=15, projection_dim=8,
              heads_num=1, heads_dim=3, head_layers=1, pos_vocab=64)
VIT = dict(dim=64, depth=2, heads=2, mlp_dim=128)
RTOL, ATOL = 2e-5, 2e-6  # tests/test_tp.py
GRAD_RTOL = 1e-5


def _batch(seed=1, n=8):
    rng = np.random.default_rng(seed)
    return {"image_u8": torch.from_numpy(rng.integers(0, 256, size=(n, 16, 16, 3))
                                         .astype(np.uint8)),
            "expression": torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)),
            "position": torch.from_numpy(rng.integers(0, 64, size=(n, 2)))}


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    """Both jobs at once, every rank a process of its own."""
    work = str(tmp_path_factory.mktemp("tp"))
    inputs = dict(layouts={"tiny": TINY, "uneven": UNEVEN},
                  steps={"tiny_cnn": TINY, "tiny_densenet": DENSENET},
                  train=dict(batch_size=8), batch=_batch())
    torch.save(inputs, os.path.join(work, "tp_job_inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import _torch_port_gloo; _torch_port_gloo.run_tp({r}, {w}, "
                               f"{work!r})"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for w in WORLDS for r in range(w)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = {w: [torch.load(os.path.join(work, f"tp_job_result_{w}_{r}.pt"),
                              weights_only=False) for r in range(w)] for w in WORLDS}
    return dict(inputs=inputs, results=results)


def _jax_state(kw):
    sample = {"image": np.zeros((1, 16, 16, 3), np.float32),
              "expression": np.zeros((1, kw["spot_dim"]), np.float32),
              "position": np.zeros((1, 2), np.int32)}
    return jax_create_train_state(JaxModelConfig(**kw), JaxTrainConfig(batch_size=8), sample)[1]


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _as_placement(spec, dims):
    """A JAX spec of a leaf as a placement on "model", where ``dims[j]`` is
    the torch dim that the leaf's dim j became."""
    sharded = [j for j, axis in enumerate(tuple(spec)) if axis == "model"]
    return Shard(dims[sharded[0]]) if sharded else Replicate()


def _name_map(params, convert):
    """{port name: (JAX leaf index, {JAX dim: torch dim})}: each leaf goes
    through ``convert`` as its elements' global indices."""
    leaves = _leaves(params)
    offsets = np.cumsum([0] + [np.size(x) for _, x in leaves])
    coded = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.arange(o, o + np.size(x), dtype=np.float64).reshape(np.shape(x))
         for o, (_, x) in zip(offsets, leaves)])
    out = {}
    for name, t in convert(coded).items():
        ids = t.numpy().astype(np.int64)
        leaf = int(np.searchsorted(offsets, ids.flat[0], side="right") - 1)
        coords = np.unravel_index(ids - offsets[leaf], np.shape(leaves[leaf][1]))
        dims = {}
        for j, c in enumerate(coords):
            moving = [t_dim for t_dim in range(ids.ndim) if ids.shape[t_dim] > 1 and
                      np.any(np.diff(c, axis=t_dim) != 0)]
            dims[j] = moving[0] if moving else j
        out[name] = (leaf, dims)
    return out


def _expected(params, specs, convert):
    spec_leaves = [s for _, s in _leaves(specs)]
    return {name: _as_placement(spec_leaves[leaf], dims)
            for name, (leaf, dims) in _name_map(params, convert).items()}


@pytest.mark.parametrize("kw", [TINY, UNEVEN], ids=["tiny", "uneven"])
def test_placements_match_jax_specs(kw):
    """Every parameter's placement by the rules is JAX's spec of the same
    leaf (translated to the torch layout), leaf for leaf."""
    params = jax.device_get(_jax_state(kw).params)
    want = _expected(params, jax_tp.tp_param_specs(params),
                     lambda coded: params_from_jax(coded, {}, ModelConfig(**kw)))
    got = tp.tp_param_placements(MclSTExp(ModelConfig(**kw), device="cpu"))
    assert got == want
    assert got["spot_encoder.0.attn.fn.to_qkv.weight"] == Shard(0)
    assert got["x_embed.weight"] == Shard(1)
    assert got["image_projection.fc.weight"] == Shard(1)
    assert got["image_encoder.conv0.weight"] == Replicate()


def test_vit_tower_placements_match_jax_specs():
    """The ViT towers' blocks match the same rules in both packages."""
    x = np.zeros((1, 224, 224, 3), np.float32)
    shapes = jax.eval_shape(jax_vit.ViTEncoder(**VIT).init, jax.random.PRNGKey(0), x)
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    want = _expected(params, jax_tp.tp_param_specs(params),
                     lambda coded: tower_params_from_jax(coded, {}, "vit"))
    got = tp.tp_param_placements(vit.ViTEncoder(**VIT))
    assert got == want
    assert sum(isinstance(p, Shard) for p in got.values()) == 4 * VIT["depth"]


def test_uneven_dims_replicate_like_jax(tp_job):
    """``shard_params`` at model 2: a weight whose sharded dim 2 does not
    divide stays replicated, as JAX's ``shard_params`` leaves it on a
    (4, 2) mesh; the others are DTensors ``[Replicate(), rule]``."""
    params = jax.device_get(_jax_state(UNEVEN).params)
    mesh = jax_make_mesh((4, 2), ("data", "model"))
    placed = jax_tp.shard_params(params, mesh)
    specs = jax.tree.map(lambda x: x.sharding.spec, placed)
    want = _expected(params, specs, lambda coded: params_from_jax(coded, {},
                                                                  ModelConfig(**UNEVEN)))
    assert want["x_embed.weight"] == Replicate()
    assert want["spot_encoder.0.attn.fn.to_qkv.weight"] == Replicate()
    for out in tp_job["results"][2]:
        layout = out[("layout", "uneven")]
        for name, placement in want.items():
            got = layout[name]
            if placement == Replicate():
                assert got is None or got[0][1] == Replicate(), name
            else:
                assert got[0] == (Replicate(), placement), name


@pytest.mark.parametrize("world", WORLDS)
def test_local_shard_shapes(tp_job, world):
    """At model 2 each rank holds half of each ruled weight's sharded dim;
    the other parameters of its module are replicated DTensors, the rest
    plain tensors."""
    model = MclSTExp(ModelConfig(**TINY), device="cpu")
    rules = tp.tp_param_placements(model)
    for out in tp_job["results"][world]:
        layout = out[("layout", "tiny")]
        for name, p in model.named_parameters():
            rule = rules[name]
            if isinstance(rule, Shard):
                shape = list(p.shape)
                shape[rule.dim] //= 2
                assert layout[name] == ((Replicate(), rule), tuple(shape)), name
            elif layout[name] is not None:
                assert layout[name] == ((Replicate(), Replicate()), tuple(p.shape)), name
        assert layout["image_encoder.conv0.weight"] is None
        assert layout["spot_encoder.0.attn.fn.to_out.0.bias"][0] == (Replicate(), Replicate())


def _fp64_grads(kw, tcfg, batch):
    """The one-process step's gradients evaluated in float64 from the same
    parameters and images (augment "none", no dropout)."""
    model = create_train_state(ModelConfig(**kw), tcfg, "cpu").model.double().train()
    image, spot = model({"image": augment.to_float(batch["image_u8"]).double(),
                         "expression": batch["expression"].double(),
                         "position": batch["position"]})
    logits = spot @ image.T / model.config.temperature
    targets = torch.eye(len(logits), dtype=torch.float64)

    def xent(lg, tg):
        return -(tg * torch.log_softmax(lg, dim=-1)).sum(dim=-1).mean()

    ((xent(logits, targets) + xent(logits.T, targets.T)) / 2.0).backward()
    return {name: p.grad for name, p in model.named_parameters()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["tiny_cnn", "tiny_densenet"])
def test_tp_step_matches_replicated(tp_job, world, tag):
    """One step with the parameters placed on the ("data", "model") mesh:
    the replicated one-process step's loss, gradients, parameters and
    running statistics. A gradient tensor whose one-process float32 value
    lies farther than 1e-5 of its largest magnitude from a float64
    evaluation (tiny_densenet's stem norm0 on uniform random pixels, ~15%
    off: its channels' spread is small against their mean, and the mesh's
    global batch norm rounds otherwise than ATen's) is held no farther from
    the float64 one than 4 times the one-process distance
    (tests/test_torch_port_dp.py)."""
    kw = tp_job["inputs"]["steps"][tag]
    tcfg = TrainConfig(**tp_job["inputs"]["train"])
    batch = tp_job["inputs"]["batch"]
    loss, grads, after, _ = step_outcome(ModelConfig(**kw), tcfg, batch)
    exact = None
    ranks = tp_job["results"][world]
    first = ranks[0][("step", tag)]
    for out in ranks:
        got_loss, got_grads, got_after = out[("step", tag)]
        np.testing.assert_allclose(got_loss, loss, rtol=RTOL)
        assert sorted(got_grads) == sorted(grads)
        for name, g in grads.items():
            scale = float(g.abs().max())
            if float((got_grads[name] - g).abs().max()) <= GRAD_RTOL * scale:
                continue
            exact = exact or _fp64_grads(kw, tcfg, batch)
            one = float((g.double() - exact[name]).abs().max())
            assert one > GRAD_RTOL * scale, (name, one)  # ill-conditioned in float32
            assert float((got_grads[name].double() - exact[name]).abs().max()) <= 4 * one, name
        for name, p in after.items():
            if p.is_floating_point():
                np.testing.assert_allclose(got_after[name].numpy(), p.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=name)
            assert torch.equal(got_after[name], first[2][name]), name
    if tag == "tiny_densenet":
        assert any(k.endswith("running_mean") for k in after)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_checkpoint_loads_in_one_process(tp_job, world):
    """``save_checkpoint_on_lead`` of the sharded state writes whole
    tensors (the model and Adam's moments), which load into a one-process
    model and optimizer with ``strict=True``."""
    out = tp_job["results"][world][0]
    model = MclSTExp(ModelConfig(**TINY), device="cpu")
    step = checkpoint.load_checkpoint(out[("ckpt", "tiny_cnn")], model)
    assert step == 1
    after = out[("step", "tiny_cnn")][2]
    for name, t in model.state_dict().items():
        assert torch.equal(t, after[name]), name
    saved = checkpoint.restore_checkpoint(out[("ckpt", "tiny_cnn")])
    moments = [s["exp_avg"] for s in saved["optimizer"]["state"].values()]
    assert len(moments) == len(list(model.parameters()))
    assert all(type(m) is torch.Tensor for m in moments)
    assert [tuple(m.shape) for m in moments] == [tuple(p.shape) for p in model.parameters()]


def test_shard_params_without_a_model_axis_is_a_no_op():
    """JAX replicates everything on a mesh without a "model" axis longer
    than 1; the port leaves the model as it is (no group is needed to
    decide)."""

    class OneModel:  # a mesh's names and sizes, all shard_params reads first
        mesh_dim_names = ("data", "model")

        @staticmethod
        def size(dim):
            return 1

    model = MclSTExp(ModelConfig(**TINY), device="cpu")
    before = {n: p for n, p in model.named_parameters()}
    assert tp.shard_params(model, OneModel()) is model
    assert all(p is before[n] for n, p in model.named_parameters())
