"""The port's data-parallel training against one process and the JAX
package, on the CPU.

One gloo job at world size 2 and one at 3, each a set of processes started
once for this module (``tests/_torch_port_gloo.py::run_dp``; a
``FileStore`` rendezvous, no TCP port), run:

* (a) the flagship fold (tiny_densenet, dropout 0.1, 19 training spots in
  batches of 8: at world 2 two sharded batches and a replicated remainder
  of 3, at world 3 two replicated full batches and a sharded remainder),
  resident and streamed past ``device_data_budget_bytes``;
* (b) ``symmetric_infonce_gathered`` and ``bleep_clip_loss_gathered`` on
  each rank's rows, values and gradients;
* (c) the global batch norm's forward, backward and running statistics;
* (d) at world 2, a fold resumed after one epoch against an uninterrupted
  one, and the checkpoint writes of each rank;
* (e) BLEEP's fold with a mesh (tiny_densenet: batch norms and dropout);
* (f) slide-DP of HisToGene and Hist2ST at narrow widths, one slide per
  rank (at world 2 a replicated last slide);
* (g) at world 2, ``cmd_train`` and ``cmd_baseline --dp`` under the group;
* (h) at world 2, the fold on a (1, 2) ("data", "model") mesh: replicas.

Tolerances: the N-rank run against one process on the global batch, one
step's gradients (a sharded batch and a replicated one, the flagship's and
BLEEP's), losses and batch-norm running statistics rtol 1e-5, each
tensor's within 1e-5 of its largest magnitude (sums over ranks in another
order, the global norm's own rounding); the parameters after the folds
the same, except that at most one element in a thousand of a tensor (at
least one) may lie within 2 lr a step of one process's: Adam's step
lr m / (sqrt(v) + eps) normalizes a gradient at the rounding floor (an
element whose terms cancel) to anywhere in (-lr, lr), so those elements'
last bits decide their step; and every element of a tensor whose
one-process float32 gradient is itself ill-conditioned (farther than 1e-5
of its largest magnitude from a float64 evaluation: the stem's norm0 on
these near-uniform synthetic patches, about 4e-2 off) within 2 lr a step. Every rank bit-equal to the others (the
all-reduced gradients are the same bits);
streamed and resumed folds bit-equal to the resident and uninterrupted
ones. The gathered losses and the global batch norm against the JAX
package (``shard_map`` over the conftest's CPU devices, and the JAX
``BatchNormT`` on the global batch): within 1e-6 of each array's largest
magnitude. One process against JAX's ``train_fold`` on a ``(N,)`` mesh:
the tolerances of ``tests/test_torch_port_train.py`` (losses rtol 1e-4,
parameters within 2 lr, running statistics rtol 1e-4 atol 1e-6).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mclstexp_tpu.baselines import losses as jax_bl
from mclstexp_tpu.config import Config as JaxConfig
from mclstexp_tpu.config import DataConfig as JaxDataConfig
from mclstexp_tpu.config import ModelConfig as JaxModelConfig
from mclstexp_tpu.config import TrainConfig as JaxTrainConfig
from mclstexp_tpu.core import losses as jax_losses
from mclstexp_tpu.models.image.common import BatchNormT as JaxBatchNormT
from mclstexp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mclstexp_tpu.train import loop as jax_loop
from mclstexp_tpu.utils.logging import MetricLogger as JaxLogger
from mclstexp_tpu_torch.baselines import trainer
from mclstexp_tpu_torch.cli import main as cli
from mclstexp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.image.common import BatchNormT, global_batch_stats
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.parallel import distributed
from mclstexp_tpu_torch.train import checkpoint, loop
from mclstexp_tpu_torch.train.state import TrainState, torch_adam
from mclstexp_tpu_torch.utils.logging import MetricLogger
from _torch_port_gloo import dp_sections, narrow_baseline, step_grads
from test_torch_port_augment import _jax_st_draws, _shears_agree

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLDS = (2, 3)
RTOL = 1e-5  # N ranks against one process, of each tensor's largest magnitude
JAX_TOL = 1e-6  # the gathered losses and the batch norm against JAX
LR = 1e-3
TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, pos_vocab=64, dense_block_impl="concat")
FOLD = dict(
    sections=dict(spots=[10, 9, 10], genes=24, patch=16),  # 19 training spots in fold 0
    model=dict(TINY, dropout=0.1),
    train=dict(batch_size=8, max_epochs=1, lr=LR, log_every=1, checkpoint_every_epochs=0,
               seed=0),
    patch=16,
)
BLEEP = dict(cfg=dict(model="bleep", n_genes=24, patch_size=16, max_epochs=1, batch_size=8,
                      encoder_name="tiny_densenet"),
             sections=dict(spots=[10, 9, 10], genes=24, patch=16))
SLIDE_DP = {  # fold 0 trains on three slides: sizes 20, 9, 15, all padded to 32
    "histogene": dict(cfg=dict(model="histogene", n_genes=8, patch_size=16, bucket=16,
                               max_epochs=2, lr=LR),
                      sections=dict(spots=[12, 20, 9, 15], genes=8, patch=16)),
    "hist2st": dict(cfg=dict(model="hist2st", n_genes=8, patch_size=28, bucket=16,
                             max_epochs=1, lr=LR, bake=1),
                    sections=dict(spots=[12, 20, 9, 15], genes=8, patch=28)),
}


def _inputs():
    rng = np.random.default_rng(7)
    return dict(
        spot=rng.normal(size=(12, 16)).astype(np.float32),
        image=rng.normal(size=(12, 16)).astype(np.float32),
        temperature=0.5,
        bn=dict(x=(2.0 * rng.normal(size=(12, 5, 3, 3)) + 0.5).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, size=5).astype(np.float32),
                bias=rng.normal(size=5).astype(np.float32),
                upstream=rng.normal(size=(12, 5, 3, 3)).astype(np.float32)),
        fold=FOLD, bleep=BLEEP, slide_dp=SLIDE_DP,
    )


@pytest.fixture(scope="module")
def dp_job(tmp_path_factory):
    """Both jobs at once, every rank a process of its own; returns the
    inputs, each rank's results and the job's directory."""
    work = str(tmp_path_factory.mktemp("dp"))
    inputs = _inputs()
    torch.save(inputs, os.path.join(work, "dp_inputs.pt"))
    os.makedirs(os.path.join(work, "cli"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import _torch_port_gloo; _torch_port_gloo.run_dp({r}, {w}, "
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
    results = {w: [torch.load(os.path.join(work, f"dp_result_{w}_{r}.pt"), weights_only=False)
                   for r in range(w)] for w in WORLDS}
    return dict(inputs=inputs, results=results, work=work)


def _close(got, want, what):
    """Within RTOL of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=what)


# Gradients zero by invariance, up to rounding: Hist2ST's conv biases that
# feed a batch norm, and coef's last bias, which adds the same to every bake
# before their softmax (tests/test_torch_port_hist2st.py). Adam's step of
# such an element is its rounding's sign: held within 2 lr a step only.
NEAR_ZERO = ("vit.transformer.layer1.0.dw.0.bias", "vit.transformer.layer1.0.dw.3.bias",
             "coef.2.bias")


def _states_close(got, want, lr: float, steps: int, loose=()):
    """Running statistics within RTOL of their largest magnitude; each
    parameter tensor too, but for at most max(1, n / 1000) elements within
    2 lr a step (the module docstring says why); the ``NEAR_ZERO`` tensors
    and those named in ``loose`` within 2 lr a step."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
        elif k.endswith(("running_mean", "running_var")):
            _close(got[k].numpy(), w.numpy(), k)
        else:
            err = (got[k] - w).abs().double()
            assert float(err.max()) <= 2 * lr * steps, (k, float(err.max()))
            if k not in NEAR_ZERO and k not in loose:
                apart = err > RTOL * max(float(w.abs().max()), 1e-30)
                assert int(apart.sum()) <= max(1, w.numel() // 1000), (k, float(err.max()))


def _states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def _fold_cfg(tmp_path, **model_kw):
    return Config(model=ModelConfig(**{**FOLD["model"], **model_kw}),
                  train=TrainConfig(**FOLD["train"], checkpoint_dir=str(tmp_path)),
                  data=DataConfig(dataset="synthetic", patch_size=FOLD["patch"]))


def _losses(logger):
    return [(r["epoch"], r["step"], r["loss"]) for r in logger.records if "loss" in r]


@pytest.mark.parametrize("world", WORLDS)
def test_flagship_fold_equals_one_process(dp_job, world, tmp_path):
    """(a) The DP fold at world N is the one-process fold on the global
    batch: the same losses, parameters and running statistics; every rank
    the same bits; the streamed fold bit-equal to the resident one."""
    logger = MetricLogger(echo=False)
    want = loop.train_fold(_fold_cfg(tmp_path), dp_sections(**FOLD["sections"]), 0, logger,
                           device="cpu")
    want_losses = _losses(logger)
    assert [len(want_losses), want.step] == [3, 3]  # batches 8, 8, 3
    loose = _ill_conditioned("flagship", _fold_cfg(tmp_path), FOLD["sections"])
    ranks = dp_job["results"][world]
    for out in ranks:
        got = out["fold"]
        assert got["step"] == want.step
        assert [(e, i) for e, i, _ in got["losses"]] == [(e, i) for e, i, _ in want_losses]
        np.testing.assert_allclose([v for *_, v in got["losses"]],
                                   [v for *_, v in want_losses], rtol=RTOL)
        _states_close(got["state"], want.model.state_dict(), LR, want.step, loose)
        _states_equal(got["state"], ranks[0]["fold"]["state"])
        assert got["losses"] == ranks[0]["fold"]["losses"]
        # past the device budget: the same batches through prefetch_to_device
        assert out["stream"]["losses"] == got["losses"]
        _states_equal(out["stream"]["state"], got["state"])


@pytest.mark.parametrize("world", WORLDS)
def test_gathered_losses_match_jax_shard_map(dp_job, world):
    """(b) Each rank's loss is JAX's under ``shard_map`` on a mesh of N CPU
    devices, and its rows' gradients are JAX's gradient of the summed
    per-device losses (N times one process's: the ranks' equal losses all
    reach each row); divided by N, the one-process gradient."""
    inputs = dp_job["inputs"]
    spot, image, t = inputs["spot"], inputs["image"], inputs["temperature"]
    mesh = jax_make_mesh((world,), ("data",))
    for name, fn, plain in (("infonce", jax_losses.symmetric_infonce_gathered,
                             jax_losses.symmetric_infonce),
                            ("bleep", jax_bl.bleep_clip_loss_gathered, jax_bl.bleep_clip_loss)):
        per_device = jax.jit(shard_map(lambda s, i: fn(s, i, t, "data")[None], mesh=mesh,
                                       in_specs=(P("data"), P("data")), out_specs=P("data")))
        values = np.asarray(per_device(spot, image))
        dspot, dimage = jax.jit(jax.grad(lambda s, i: per_device(s, i).sum(),
                                         argnums=(0, 1)))(spot, image)
        one = jax.jit(jax.grad(lambda s, i: plain(s, i, t), argnums=(0, 1)))(spot, image)
        per = len(spot) // world
        for r, out in enumerate(dp_job["results"][world]):
            loss, gs, gi = out[f"gathered_{name}"]
            rows = slice(r * per, (r + 1) * per)
            assert abs(loss - float(values[r])) <= JAX_TOL * abs(float(values[r])), name
            for got, want, single in ((gs, dspot, one[0]), (gi, dimage, one[1])):
                want = np.asarray(want)[rows]
                scale = np.abs(want).max()
                np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL * scale, err_msg=name)
                np.testing.assert_allclose(got / world, np.asarray(single)[rows], rtol=0,
                                           atol=JAX_TOL * scale, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_global_batch_norm_matches_one_process_and_jax(dp_job, world):
    """(c) The norm over every rank's rows: each rank's outputs and input
    gradients are the one-process norm's on the global batch, its
    parameter gradients sum over the ranks to the one-process ones, and
    its running statistics (the variance unbiased by the global count) are
    the one-process norm's; all of it JAX's ``BatchNormT`` on the global
    batch. The group is unset after the block."""
    bn_in = dp_job["inputs"]["bn"]
    bn = BatchNormT(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(bn_in["weight"]))
        bn.bias.copy_(torch.from_numpy(bn_in["bias"]))
    x = torch.tensor(bn_in["x"], requires_grad=True)
    y = bn.train()(x)
    (y * torch.from_numpy(bn_in["upstream"])).sum().backward()

    jbn = JaxBatchNormT(use_running_average=False)
    xj = jnp.asarray(bn_in["x"].transpose(0, 2, 3, 1))
    params = {"scale": jnp.asarray(bn_in["weight"]), "bias": jnp.asarray(bn_in["bias"])}
    stats = {"mean": jnp.zeros(5), "var": jnp.ones(5)}

    def jloss(p, xx):
        out, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return (out * jnp.asarray(bn_in["upstream"].transpose(0, 2, 3, 1))).sum(), (out, upd)

    (_, (jy, jupd)), (jgp, jdx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, xj)
    jax_ref = dict(y=np.asarray(jy).transpose(0, 3, 1, 2), dx=np.asarray(jdx).transpose(0, 3, 1, 2),
                   dweight=np.asarray(jgp["scale"]), dbias=np.asarray(jgp["bias"]),
                   running_mean=np.asarray(jupd["batch_stats"]["mean"]),
                   running_var=np.asarray(jupd["batch_stats"]["var"]))
    one = dict(y=y.detach().numpy(), dx=x.grad.numpy(), dweight=bn.weight.grad.numpy(),
               dbias=bn.bias.grad.numpy(), running_mean=bn.running_mean.numpy(),
               running_var=bn.running_var.numpy())
    ranks = dp_job["results"][world]
    per = 12 // world
    got = {k: np.concatenate([out["bn"][k] for out in ranks]) for k in ("y", "dx")}
    for k in ("dweight", "dbias"):
        got[k] = sum(out["bn"][k] for out in ranks)
    got["running_mean"], got["running_var"] = (ranks[0]["bn"]["running_mean"],
                                               ranks[0]["bn"]["running_var"])
    for r, out in enumerate(ranks):
        assert out["bn"]["group_after"] is None
        np.testing.assert_array_equal(out["bn"]["running_var"], got["running_var"])
        assert out["bn"]["y"].shape == (per, 5, 3, 3)
    for k, want in one.items():
        _close(got[k], want, k)
        scale = np.abs(jax_ref[k]).max()
        np.testing.assert_allclose(got[k], jax_ref[k], rtol=0, atol=JAX_TOL * scale, err_msg=k)


def test_global_batch_norm_keeps_precision_far_from_zero():
    """Inputs 3e4 from zero against a unit spread (a channel a norm must
    center first), an upstream gradient that follows the normalized input:
    over a one-rank group the norm's input gradient lies no farther from a
    float64 evaluation than 1.5 times the one-process norm's (``x - mean``
    is taken before any product; rearranged as ``x * a + c`` the product's
    rounding cost 7.5 times)."""
    from mclstexp_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator().manual_seed(0)
    x0 = 3e4 + torch.randn((32, 4, 5, 5), generator=gen)
    upstream = torch.randn((32, 4, 5, 5), generator=gen) + 3.0 * (x0 - 3e4)
    grads = {}
    try:
        group = make_mesh(device="cpu").get_group(0)
        for name, dtype, grp in (("exact", torch.float64, None), ("one", torch.float32, None),
                                 ("group", torch.float32, group)):
            bn = BatchNormT(4).train().to(dtype)
            x = x0.to(dtype).clone().requires_grad_()
            with global_batch_stats(bn, grp) if grp is not None else contextlib.nullcontext():
                y = bn(x)
            (y * upstream.to(dtype)).sum().backward()
            grads[name] = x.grad.double()
    finally:
        distributed.shutdown()
    scale = float(grads["exact"].abs().max())
    one, group_err = (float((grads[k] - grads["exact"]).abs().max()) / scale
                      for k in ("one", "group"))
    assert group_err <= 1.5 * one and one < 1e-2


def test_resume_at_world_two_and_only_rank_zero_writes(dp_job):
    """(d) One epoch, then resume=True to two, at world 2: the losses and
    the state (model, Adam) bit-equal to two epochs in one go on every
    rank; rank 0 wrote every checkpoint and the log, the other rank none."""
    ranks = dp_job["results"][2]
    for out in ranks:
        whole, resumed = out["whole"], out["resumed"]
        assert resumed["resumed"] == [1] and resumed["step"] == whole["step"] == 6
        assert whole["losses"][3:] == resumed["losses"]
        _states_equal(resumed["state"], whole["state"])
        for a, b in zip(whole["optimizer"]["state"].values(),
                        resumed["optimizer"]["state"].values()):
            for key in a:
                assert torch.equal(a[key], b[key])
    work = dp_job["work"]
    assert sorted(os.path.relpath(p, work).split(os.sep)[0] for p in ranks[0]["writes"]) == \
        ["fold_2", "model_axis", "split", "split", "stream_2", "whole"]
    assert ranks[1]["writes"] == []
    with open(os.path.join(work, "whole", "log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["loss"] for r in lines if "loss" in r] == [v for *_, v in ranks[0]["whole"]["losses"]]
    assert os.path.exists(checkpoint.fold_checkpoint_dir(os.path.join(work, "whole"), "synthetic",
                                                         "S1", 0))


def test_model_axis_raises(dp_job, tmp_path):
    """(h) A (1, 2) ("data", "model") mesh (it raised before the
    tensor-parallel layouts were ported; the name stays): ``train_fold``
    shards the batch on "data" only, as JAX's loop does, so the two model
    ranks train replicas, each the one-process fold, the same bits on
    both."""
    logger = MetricLogger(echo=False)
    want = loop.train_fold(_fold_cfg(tmp_path), dp_sections(**FOLD["sections"]), 0, logger,
                           device="cpu")
    loose = _ill_conditioned("flagship", _fold_cfg(tmp_path), FOLD["sections"])
    ranks = dp_job["results"][2]
    for out in ranks:
        got = out["model_axis"]
        assert got["step"] == want.step == 3
        np.testing.assert_allclose([v for *_, v in got["losses"]],
                                   [v for *_, v in _losses(logger)], rtol=RTOL)
        _states_close(got["state"], want.model.state_dict(), LR, want.step, loose)
        _states_equal(got["state"], ranks[0]["model_axis"]["state"])


def _ill_conditioned(kind, cfg, secs):
    """The parameters whose one-process float32 gradient, on the first 8
    training spots, lies farther than RTOL of its largest magnitude from a
    float64 evaluation: their gradient is known to a few per cent at best
    (the stem's norm0 here), so Adam's steps, which normalize it, part at
    that level; the folds hold them within 2 lr a step only."""
    fp32 = step_grads(kind, cfg, dp_sections(**secs), 8)
    fp64 = _fp64_step_grads(kind, cfg, dp_sections(**secs), 8)
    return {k for k, g in fp32.items()
            if float((g.double() - fp64[k]).abs().max()) > RTOL * float(g.abs().max())}


@pytest.mark.parametrize("world", WORLDS)
def test_bleep_fold_with_a_mesh_equals_one_process(dp_job, world):
    """(e) BLEEP over the group (global batch norms in the tower, the global
    batch's dropout masks, the gathered CLIP loss) is one process's fold."""
    cfg = trainer.BaselineConfig(**BLEEP["cfg"])
    want = trainer.train_bleep_fold(cfg, dp_sections(**BLEEP["sections"]), 0, device="cpu")
    loose = _ill_conditioned("bleep", cfg, BLEEP["sections"])
    assert loose and all(k.startswith("image_encoder.") for k in loose)
    for out in dp_job["results"][world]:
        _states_close(out["bleep"], want.model.state_dict(), trainer.resolve_lr(cfg), want.step,
                      loose)
        _states_equal(out["bleep"], dp_job["results"][world][0]["bleep"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", sorted(SLIDE_DP))
def test_slide_dp_over_the_group_equals_one_process(dp_job, world, family, monkeypatch):
    """(f) One slide per rank a step (at world 2 the last step's one slide
    replicated) equals one process's slide-DP at D = N."""
    monkeypatch.setattr(trainer, "build_baseline", narrow_baseline)
    case = SLIDE_DP[family]
    logger = MetricLogger(echo=False)
    want = trainer.train_baseline_fold(trainer.BaselineConfig(**case["cfg"]),
                                       dp_sections(**case["sections"]), 0, logger=logger,
                                       device="cpu", slides_per_step=world)
    steps = -(-3 // world) * case["cfg"]["max_epochs"]
    for out in dp_job["results"][world]:
        got = out["slide_dp"][family]
        assert got["step"] == want.step == steps
        np.testing.assert_allclose(got["losses"], [r["loss"] for r in logger.records],
                                   rtol=RTOL)
        _states_close(got["state"], want.model.state_dict(), LR, want.step)
        _states_equal(got["state"], dp_job["results"][world][0]["slide_dp"][family]["state"])


def _printed_json(text: str):
    """The JSON object a command printed last (after the epoch lines)."""
    return json.loads(text[text.index("{\n"):] if not text.startswith("{") else text)


def _fp64_step_grads(kind, cfg, sections, batch_size):
    """``step_grads``' one-process step evaluated in float64 from the same
    float32 augmented images, dropout masks and parameters."""
    from mclstexp_tpu_torch.core.layers import seed_dropout
    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData, split_fold
    from mclstexp_tpu_torch.train.state import create_train_state

    train_secs, _ = split_fold(sections, 0)
    batch = DeviceResidentData(ConcatSections.from_sections(train_secs), "cpu").take(
        np.arange(batch_size))
    generator = augment.reseed(torch.Generator(), 5, 0, 0)
    if kind == "flagship":
        model = create_train_state(cfg.model, cfg.train, "cpu").model
        images = augment.train_augment_inline(
            batch["image_u8"], augment.sample_st_draws(generator, batch_size, "cpu"))
        inputs = {"image": images.double(), "expression": batch["expression"].double(),
                  "position": batch["position"]}
    else:
        model = trainer.init_baseline(cfg, "cpu").model
        inputs = {"image": augment.to_float(batch["image_u8"]).double(),
                  "expression": batch["expression"].double()}
    model = model.double().train()
    seed_dropout(model, generator)
    image, spot = model(inputs)
    logits = spot @ image.T / (cfg.model.temperature if kind == "flagship" else cfg.temperature)
    if kind == "flagship":
        targets = torch.eye(batch_size, dtype=torch.float64)
    else:
        t = cfg.temperature
        targets = torch.softmax((image @ image.T + spot @ spot.T) / 2.0 / t, dim=-1)

    def xent(lg, tg):
        return -(tg * torch.log_softmax(lg, dim=-1)).sum(dim=-1).mean()

    ((xent(logits, targets) + xent(logits.T, targets.T)) / 2.0).backward()
    return {name: p.grad for name, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["flagship", "bleep"])
@pytest.mark.parametrize("batch", [6, 5])
def test_one_step_gradients_equal_one_process(dp_job, world, kind, batch):
    """One step's gradients over the group, after the average, on a batch
    the ranks divide (6: gathered losses, global batch norms) and on one
    they do not (5: replicated), are one process's on the same batch and
    draws, within RTOL of each tensor's largest magnitude; every rank holds
    the same bits. Where the one-process float32 gradient itself lies
    farther than RTOL from a float64 evaluation of the step (a batch norm
    over channels whose spread is small against their mean: the stem's
    norm0 on these near-uniform synthetic patches, 1e-2 to 4e-2 off), the
    group's is held to be no farther from the float64 one than 4 times the
    one-process distance: each rank's convolutions sum its own rows in
    another order, and such a gradient's float32 error moves by a few times
    with the order (measured up to 2.1 times). (Adam normalizes a
    gradient's scale away, so this, not the parameters, is what shows a
    gradient N times too large.)"""
    if kind == "flagship":
        cfg, secs = _fold_cfg(TESTS), FOLD["sections"]
    else:
        cfg, secs = trainer.BaselineConfig(**BLEEP["cfg"]), BLEEP["sections"]
    want = step_grads(kind, cfg, dp_sections(**secs), batch)
    exact = None
    ranks = dp_job["results"][world]
    for out in ranks:
        got = out["grads"][(kind, batch)]
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert torch.equal(got[name], ranks[0]["grads"][(kind, batch)][name])
            scale = float(w.abs().max())
            if float((got[name] - w).abs().max()) <= RTOL * scale:
                continue
            if exact is None:
                exact = _fp64_step_grads(kind, cfg, dp_sections(**secs), batch)
            one = float((w.double() - exact[name]).abs().max())
            assert one > RTOL * scale, (name, one)  # ill-conditioned in float32
            assert float((got[name].double() - exact[name]).abs().max()) <= 4 * one, name


def test_cli_train_and_baseline_dp_under_a_group(dp_job, tmp_path, monkeypatch):
    """(g) ``train`` and ``baseline --dp`` as ranks of a 2-process group
    (HisToGene at the narrow widths): both exit 0, rank 0 alone prints and
    writes, and the checkpoints and scores are one process's: ``train``'s
    without a group, ``baseline``'s from ``train_baseline_fold`` with two
    slides a step."""
    ranks = dp_job["results"][2]
    work = os.path.join(dp_job["work"], "cli")
    for name in ("cli_train", "cli_baseline"):
        assert [out[name][0] for out in ranks] == [0, 0]
    assert ranks[1]["cli_baseline"][1] == "" and ranks[1]["cli_train"][1] == ""
    got_scores = _printed_json(ranks[0]["cli_baseline"][1])

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer, "build_baseline", narrow_baseline)
    slide_fold = trainer.train_baseline_fold

    def two_slides(cfg, sections, fold, device, mesh):
        assert mesh is not None and distributed.world_size() == 1  # --dp without torchrun
        return slide_fold(cfg, sections, fold, device=device, slides_per_step=2)

    monkeypatch.setattr(trainer, "train_baseline_fold", two_slides)
    common = ["--dataset", "synthetic", "--fold", "0", "--max_epochs", "1", "--device", "cpu"]
    assert cli.main(["train"] + common) == 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert cli.main(["baseline", "--baseline", "histogene", "--dp"] + common) == 0
    assert not distributed.is_initialized()
    want_scores = _printed_json(printed.getvalue())
    assert sorted(got_scores) == sorted(want_scores)
    for k, v in want_scores.items():
        assert abs(got_scores[k] - v) <= RTOL * max(abs(v), 1e-3), k
    for rel in (os.path.join("synthetic", "S1", "best_0"),
                os.path.join("baselines", "histogene", "best_0")):
        got = checkpoint.restore_checkpoint(os.path.join(work, "model_result", rel))
        want = checkpoint.restore_checkpoint(os.path.join("model_result", rel))
        assert got["step"] == want["step"]
        lr = 1e-4 if rel.startswith("synthetic") else 1e-5  # the CLI's and HisToGene's
        _states_close(got["model"], want["model"], lr, want["step"])
    with open(os.path.join(work, "model_result", "train_log.jsonl")) as f:
        assert sum("epoch_loss" in json.loads(line) for line in f) == 1  # one writer


def _capture_jax_init(monkeypatch):
    """A list that JAX's ``train_fold`` appends its initial state to (a host
    copy: training donates the buffers)."""
    created = []
    jax_create = jax_loop.create_train_state

    def capture(*args, **kw):
        model, state = jax_create(*args, **kw)
        created.append(jax.device_get(state))
        return model, state

    monkeypatch.setattr(jax_loop, "create_train_state", capture)
    return created


@pytest.mark.parametrize("world", WORLDS)
def test_one_process_fold_matches_jax_on_a_mesh(world, tmp_path, monkeypatch):
    """One process against JAX's ``train_fold`` on a ``(N,)`` mesh of the
    conftest's CPU devices (the global-batch step, sharded batches and
    replicated ones), from the same initial parameters, with the JAX
    step's augmentation draws and dropout 0: the tolerances of
    ``tests/test_torch_port_train.py``."""
    from mclstexp_tpu.data import synthetic as jax_synthetic

    spots, genes, patch = FOLD["sections"]["spots"], FOLD["sections"]["genes"], FOLD["patch"]
    loadings = np.random.default_rng(0).normal(size=(4, genes))
    theirs = [jax_synthetic.make_section(f"S{i + 1}", n, genes, patch, seed=100 + i,
                                         gene_loadings=loadings) for i, n in enumerate(spots)]
    ours = dp_sections(**FOLD["sections"])
    train_kw = dict(FOLD["train"], max_epochs=2)
    jcfg = JaxConfig(model=JaxModelConfig(**TINY),
                     train=JaxTrainConfig(**train_kw, checkpoint_dir=str(tmp_path / "jax")),
                     data=JaxDataConfig(dataset="synthetic", patch_size=patch))
    created = _capture_jax_init(monkeypatch)
    jlog = JaxLogger(echo=False)
    jstate = jax_loop.train_fold(jcfg, theirs, 0, logger=jlog,
                                 mesh=jax_make_mesh((world,), ("data",)))
    init = created[0]

    def shared_state(model_cfg, train_cfg, device):
        model = MclSTExp(model_cfg, device=device)
        model.load_state_dict(params_from_jax(init.params, init.batch_stats, model_cfg),
                              strict=True)
        return TrainState(model, torch_adam(model.parameters(), train_cfg.lr,
                                            train_cfg.weight_decay))

    def jax_draws(key, b, device):
        base, epoch, step = key
        rng = jax.random.fold_in(jax.random.PRNGKey(base), epoch * 100000 + step)
        draws = _jax_st_draws(jax.random.split(rng)[0], b)
        assert _shears_agree(draws.angles.numpy())
        return draws

    monkeypatch.setattr(loop, "create_train_state", shared_state)
    monkeypatch.setattr(augment, "reseed", lambda generator, *key: key)
    monkeypatch.setattr(augment, "sample_st_draws", jax_draws)
    cfg = Config(model=ModelConfig(**TINY),
                 train=TrainConfig(**train_kw, checkpoint_dir=str(tmp_path / "port")),
                 data=DataConfig(dataset="synthetic", patch_size=patch))
    log = MetricLogger(echo=False)
    state = loop.train_fold(cfg, ours, 0, logger=log, device="cpu")
    got, want = _losses(log), [(r["epoch"], r["step"], r["loss"]) for r in jlog.records
                               if "loss" in r]
    assert len(got) == len(want) == 6
    for (e, i, a), (je, ji, b) in zip(got, want):
        assert (e, i) == (je, ji)
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=f"epoch {e} step {i}")
    ref = params_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
                          cfg.model)
    mine = state.model.state_dict()
    for k, w in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(mine[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(mine[k].numpy(), w.numpy(), rtol=0, atol=2 * LR,
                                       err_msg=k)


def test_train_mesh_from_the_config(tmp_path):
    """``TrainConfig.mesh_shape`` / ``mesh_axes`` make the fold's mesh: none
    for one process without a group, a one-rank group for a configured
    shape (destroyed here), and the axis check."""
    from mclstexp_tpu_torch.parallel.mesh import train_mesh

    assert not distributed.is_initialized()
    assert train_mesh(None, ("data",), "cpu") is None
    try:
        mesh = train_mesh((1, 1), ("data", "model"), "cpu")
        assert mesh.mesh_dim_names == ("data", "model") and distributed.world_size() == 1
        with pytest.raises(ValueError, match="'data' axis"):
            train_mesh((1,), ("seq",), "cpu")
        cfg = _fold_cfg(tmp_path, dropout=0.0)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, mesh_shape=(1,)))
        state = loop.train_fold(cfg, dp_sections(**FOLD["sections"]), 0, device="cpu")
        assert state.step == 3
    finally:
        distributed.shutdown()
