"""The port's training paths on the card.

These tests need an NVIDIA card and skip without one:

    python -m pytest --noconftest tests/test_torch_port_card_train.py -m gpu

The her2st flagship (DenseNet121, 785 genes, 8 x 64 heads, batch 128) trains
fold 0 of three synthetic sections of 225 spots (3 full batches and a
remainder of 66): with "xla" attention, row_shift's three Paeth shears a step;
the forward against the CPU's; with "flash", every attention of the spot tower
in the three flash kernels, its gradients against "xla"; resumed from its
checkpoint; a raw-scale "tenx" step; the fold streamed past the device budget,
bit-equal to the resident fold; in bf16; under a one-rank NCCL group (the
data-parallel step, the global batch norm); and the sequence- and
tensor-parallel paths over that group (a ring of one rank, a "model" axis of
one).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import pytest
import torch

from _torch_port_card import (DP_GRAD_ILL_FACTOR, DP_LOSS_RTOL, DP_NORM_RTOL, DP_STAT_RTOL,
                              GRAD_RTOL, card, check_grads, child_env,  # noqa: F401
                              flagship_sections, flash_counts, fp64_grads, losses, no_tf32,
                              one_step_grads, reset_counts, shear_launches, state_diff, xent64)
from mclstexp_tpu_torch.config import her2st_config
from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData, num_train_steps
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops.row_shift import row_shift
from mclstexp_tpu_torch.train.loop import train_fold
from mclstexp_tpu_torch.train.state import create_train_state
from mclstexp_tpu_torch.train.step import make_train_step
from mclstexp_tpu_torch.utils.logging import MetricLogger

pytestmark = pytest.mark.gpu


def _fold(cfg, sections, resume: bool = False, mesh=None):
    """train_fold (over ``mesh`` if given) with the counts set to 0 just
    before it and read just after."""
    logger = MetricLogger(echo=False)
    reset_counts()
    state = train_fold(cfg, sections, fold=0, logger=logger, device="cuda", resume=resume,
                       mesh=mesh)
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        state=state, losses=losses(logger), counts=flash_counts(),
        shifts=dict(row_shift.kernel_launches), launches=row_shift.launches,
        resumed=[r for r in logger.records if r.get("event") == "resume"])


def _in(cfg, path, **model):
    return cfg.replace(model=dataclasses.replace(cfg.model, **model),
                       train=dataclasses.replace(cfg.train, checkpoint_dir=str(path)))


@pytest.fixture(scope="module")
def flagship(card, tmp_path_factory):
    """Fold 0 at the her2st widths with "xla" attention."""
    cfg = her2st_config(str(tmp_path_factory.mktemp("model_result")))
    sections = flagship_sections(cfg)
    steps = num_train_steps(sum(s.num_spots for s in sections[1:]), cfg.train.batch_size)
    return types.SimpleNamespace(cfg=cfg, sections=sections, steps=steps,
                                 run=_fold(cfg, sections))


@pytest.fixture(scope="module")
def flash_fold(flagship, tmp_path_factory):
    """The same fold with attn_backend="flash"."""
    cfg = _in(flagship.cfg, tmp_path_factory.mktemp("model_result_flash"), attn_backend="flash")
    return types.SimpleNamespace(cfg=cfg, run=_fold(cfg, flagship.sections))


def _step_batch(cfg, sections):
    """One full training batch on the card and "st" draws for it."""
    data = DeviceResidentData(ConcatSections.from_sections(sections[1:]), "cuda")
    batch = data.take(list(range(cfg.train.batch_size)))
    g = torch.Generator(device="cuda").manual_seed(1)
    return batch, augment.sample_st_draws(g, cfg.train.batch_size, "cuda")


def _spot_grads(model, img_emb, batch):
    """The spot tower's parameter gradients of the InfoNCE loss against
    fixed image embeddings (train mode; the image tower is left out so that
    only the attention backend differs between two models)."""
    from mclstexp_tpu_torch.core.losses import symmetric_infonce

    model.train()
    model.zero_grad(set_to_none=True)
    spot = model.encode_spots(batch["expression"], batch["position"])
    symmetric_infonce(spot, img_emb, model.config.temperature).backward()
    return {name: p.grad.clone() for name, p in model.named_parameters() if p.grad is not None}


def test_flagship_fold(flagship):
    """Every step taken and logged, finite; row_shift 3 launches a step, two
    row shears (shift_rows16) and one column shear (shift_cols_band)."""
    run, steps = flagship.run, flagship.steps
    assert run.state.step == steps and len(run.losses) == steps
    assert run.launches == 3 * steps and run.shifts == shear_launches(steps), run.shifts


def test_flagship_forward_matches_cpu(flagship):
    """The card's forward (eval mode, cuDNN without TF32) against the same
    weights on the CPU: both embeddings within 1e-3."""
    cfg, state, s = flagship.cfg, flagship.run.state, flagship.sections[0]
    batch = {"image": torch.from_numpy(s.patches[:4]).float() / 255.0,
             "expression": torch.from_numpy(s.expression[:4]),
             "position": torch.from_numpy(s.positions[:4]).long()}
    ref = MclSTExp(cfg.model, device="cpu")
    ref.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()}, strict=True)
    ref.eval()
    state.model.eval()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = state.model({k: v.cuda() for k, v in batch.items()})
            want = ref(batch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for name, g, w in zip(("image", "spot"), got, want):
        g = g.cpu()
        assert g.shape == (4, cfg.model.projection_dim) and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


def test_tenx_step_images_match_cpu(flagship):
    """One augment_mode="tenx" step (raw scale): its augmented images against
    the CPU's for the same draws, bit for bit; a finite loss."""
    cfg, state = flagship.cfg, flagship.run.state
    data = DeviceResidentData(ConcatSections.from_sections(flagship.sections[1:]), "cuda")
    batch = data.take(list(range(cfg.train.batch_size)))
    g = torch.Generator(device="cuda")
    draws = augment.sample_tenx_draws(augment.reseed(g, 0, 0, 0), cfg.train.batch_size, "cuda")
    tenx, seen = augment.tenx_augment, []

    def record(*args, **kw):
        seen.append(tenx(*args, **kw))
        return seen[-1]

    augment.tenx_augment = record
    try:
        loss = float(make_train_step("tenx", tenx_raw_scale=True)(state, batch, draws))
    finally:
        augment.tenx_augment = tenx
    cpu_draws = augment.TenxDraws(draws.hflip.cpu(), draws.vflip.cpu(), draws.rot.cpu())
    want = augment.tenx_augment(batch["image_u8"].cpu(), cpu_draws, raw_scale=True)
    assert len(seen) == 1 and torch.equal(seen[0].cpu(), want)
    assert math.isfinite(loss)


def test_flash_fold_and_its_gradients(flagship, flash_fold):
    """attn_backend="flash": head_layers launches of the forward, dK/dV and
    dQ a step, the shears as with "xla"; one batch's spot-tower gradients
    against the "xla" model's from the same weights, each tensor within
    GRAD_RTOL of its largest magnitude."""
    cfg, run, steps = flash_fold.cfg, flash_fold.run, flagship.steps
    want = cfg.model.head_layers * steps
    assert run.state.step == steps and len(run.losses) == steps
    assert run.counts == (want, want, want), run.counts
    assert run.shifts == shear_launches(steps), run.shifts

    batch, draws = _step_batch(cfg, flagship.sections)
    xla_model = MclSTExp(dataclasses.replace(cfg.model, attn_backend="xla"), device="cuda")
    xla_model.load_state_dict(run.state.model.state_dict())
    with torch.no_grad():
        images = augment.train_augment_inline(batch["image_u8"], draws)
        img_emb = run.state.model.eval().encode_image(images)
    got, want_grads = (_spot_grads(run.state.model, img_emb, batch),
                       _spot_grads(xla_model, img_emb, batch))
    assert set(got) == set(want_grads) and any("spot_encoder" in k for k in got), sorted(got)
    for name, g in got.items():
        scale = float(want_grads[name].abs().max())
        err = float((g - want_grads[name]).abs().max()) / max(scale, 1e-30)
        assert torch.isfinite(g).all() and err <= GRAD_RTOL, (name, err, scale)


def test_flash_fold_resumes(flagship, flash_fold):
    """The flash fold resumed from its final checkpoint for a second epoch:
    one resume record at epoch 1, to step 2 x steps, the launches of one
    epoch."""
    cfg, steps = flash_fold.cfg, flagship.steps
    rcfg = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=2))
    run = _fold(rcfg, flagship.sections, resume=True)
    want = cfg.model.head_layers * steps
    assert [r["epoch"] for r in run.resumed] == [1], run.resumed
    assert run.state.step == 2 * steps and len(run.losses) == steps
    assert run.counts == (want, want, want), run.counts


# The fold past the device budget in a process of its own, with deterministic
# algorithms, so that two folds can be bit-equal at all.
_STREAM_CHILD = """import dataclasses, json, os, sys
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cudnn.benchmark = False
from mclstexp_tpu_torch.config import her2st_config
from mclstexp_tpu_torch.data import pipeline, synthetic
from mclstexp_tpu_torch.ops.row_shift import row_shift
from mclstexp_tpu_torch.train import loop
from mclstexp_tpu_torch.utils.logging import MetricLogger
out_dir = sys.argv[1]
cfg = her2st_config(out_dir)
m = cfg.model
sections = synthetic.make_dataset(num_sections=3, num_spots=225, num_genes=m.spot_dim,
                                  patch_size=cfg.data.patch_size, seed=0)
streamed = []
prefetch = loop.prefetch_to_device
def counting(*args, **kw):
    streamed.append(1)
    return prefetch(*args, **kw)
loop.prefetch_to_device = counting
result = {}
for name, budget in (("resident", cfg.train.device_data_budget_bytes), ("streamed", 0)):
    run = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=2,
                                                device_data_budget_bytes=budget))
    row_shift.kernel_launches = dict.fromkeys(row_shift.kernel_launches, 0)
    logger = MetricLogger(echo=False)
    state = loop.train_fold(run, sections, 0, logger, device="cuda")
    torch.cuda.synchronize()
    result[name] = dict(losses=[r["loss"] for r in logger.records if "loss" in r],
                        launches=dict(row_shift.kernel_launches), streams=len(streamed))
    torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
               os.path.join(out_dir, name + ".pt"))
    del state
print(json.dumps(result), flush=True)
"""


def test_streamed_fold_equals_resident_fold(card, tmp_path):
    """The "xla" fold past the device budget (``device_data_budget_bytes=0``):
    every batch streamed through ``prefetch_to_device`` (two epochs, one
    stream each), the same losses, parameters and running statistics bit for
    bit as the resident fold, row_shift's shears launched alike."""
    proc = subprocess.run([sys.executable, "-c", _STREAM_CHILD, str(tmp_path)],
                          capture_output=True, text=True, timeout=600,
                          env=child_env(CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert proc.returncode == 0, \
        f"exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}"
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    resident, streamed = result["resident"], result["streamed"]
    want = torch.load(tmp_path / "resident.pt", weights_only=True)
    got = torch.load(tmp_path / "streamed.pt", weights_only=True)
    assert resident["streams"] == 0 and streamed["streams"] == 2
    assert streamed["losses"] == resident["losses"]
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], w) for k, w in want.items())
    assert streamed["launches"] == resident["launches"]


def test_bf16_flagship_fold(flagship, tmp_path):
    """dtype "bfloat16" with "flash": every attention of the spot tower in
    the bf16 kernels, none in the fp32 ones; row_shift's shears on bf16
    images; fp32 parameters and checkpoint; fp32, finite embeddings of every
    spot and a finite LOO fold."""
    from mclstexp_tpu_torch.infer import embed, evaluate
    from mclstexp_tpu_torch.train import checkpoint

    cfg, sections, steps = flagship.cfg, flagship.sections, flagship.steps
    bcfg = _in(cfg, tmp_path, dtype="bfloat16", attn_backend="flash")
    run = _fold(bcfg, sections)
    want = bcfg.model.head_layers * steps
    assert run.state.step == steps
    assert flash_counts(prefix="bf16_") == (want,) * 3 and run.counts == (0, 0, 0)
    assert run.shifts == shear_launches(steps), run.shifts
    assert all(p.dtype == torch.float32 for p in run.state.model.parameters())
    saved = checkpoint.fold_checkpoint_dir(bcfg.train.checkpoint_dir, bcfg.data.dataset,
                                           sections[0].name, 0)
    assert os.path.isfile(os.path.join(saved, checkpoint.STATE_FILE)), saved

    prepared = embed.prepare_eval_arrays(sections, device="cuda")
    img, spot = embed.compute_embeddings(run.state.model, sections, bcfg.eval.batch_size,
                                         prepared=prepared, as_device=True, device="cuda")
    assert img.dtype == torch.float32
    assert torch.isfinite(img).all() and torch.isfinite(spot).all()
    metrics = evaluate.evaluate_fold_resident(
        0, img, spot, prepared["eval_expression"],
        evaluate.section_bounds([s.num_spots for s in sections]), sections[0].eval_expression,
        top_k=bcfg.eval.top_k, weight_ord=bcfg.eval.weight_ord, device="cuda")
    assert all(math.isfinite(v) for v in metrics.values()), metrics


# --- under a one-rank NCCL group ---------------------------------------------------------------

@pytest.fixture(scope="module")
def nogroup_fold(flash_fold, flagship, tmp_path_factory):
    """The flash fold again, from fresh weights, before any group exists."""
    cfg = _in(flash_fold.cfg, tmp_path_factory.mktemp("model_result_nogroup"))
    return _fold(cfg, flagship.sections)


@pytest.fixture(scope="module")
def group(card):
    """A one-rank NCCL group (``make_mesh``), destroyed after the module."""
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.parallel.mesh import make_mesh

    try:
        yield make_mesh(device="cuda")
    finally:
        distributed.shutdown()


def test_data_parallel_fold(flash_fold, flagship, nogroup_fold, group, tmp_path):
    """The flash fold over the group (the global batch norm,
    ``symmetric_infonce_gathered``, the gradient average): the launches of
    the fold without a group; its losses within rtol DP_LOSS_RTOL of that
    fold's, every parameter within 2 lr a step, the running statistics
    within DP_STAT_RTOL of each tensor's largest magnitude."""
    cfg, steps = flash_fold.cfg, flagship.steps
    run = _fold(_in(cfg, tmp_path), flagship.sections, mesh=group)
    want = cfg.model.head_layers * steps
    assert run.state.step == steps and run.counts == (want, want, want)
    assert run.shifts == shear_launches(steps), run.shifts
    for a, b in zip(run.losses, nogroup_fold.losses):
        assert math.isclose(a, b, rel_tol=DP_LOSS_RTOL), (run.losses, nogroup_fold.losses)
    param, stat = state_diff(run.state.model.state_dict(), nogroup_fold.state.model.state_dict())
    assert param <= 2 * cfg.train.lr * steps and stat <= DP_STAT_RTOL, (param, stat)


def test_global_batch_norm_matches_cudnn(flash_fold, flagship, nogroup_fold, group):
    """The global norm alone: one train-mode forward of the image tower from
    the same weights on the same images, with and without it (TF32 off):
    features and running statistics within DP_NORM_RTOL of their largest
    magnitude."""
    import copy

    from mclstexp_tpu_torch.models.image.common import global_batch_stats

    batch, draws = _step_batch(flash_fold.cfg, flagship.sections)
    images = augment.train_augment_inline(batch["image_u8"], draws)
    towers = [copy.deepcopy(nogroup_fold.state.model.tower).train() for _ in range(2)]
    with no_tf32(), torch.no_grad():
        plain_feats = towers[0](images)
        with global_batch_stats(towers[1], torch.distributed.group.WORLD):
            group_feats = towers[1](images)
    out_err = float((group_feats - plain_feats).abs().max()) / float(plain_feats.abs().max())
    stat = state_diff(towers[1].state_dict(), towers[0].state_dict())[1]
    assert out_err <= DP_NORM_RTOL and stat <= DP_NORM_RTOL, (out_err, stat)


def test_data_parallel_step_gradients(flash_fold, flagship, group):
    """One step's loss and gradients over the group against the step without
    a group, from the same weights, batch and draws (TF32 off), as
    ``check_grads`` holds them; the float64 step takes "xla" attention (the
    kernels are fp32)."""
    from mclstexp_tpu_torch.train.step import Shard

    cfg = flash_fold.cfg
    batch, draws = _step_batch(cfg, flagship.sections)
    n = cfg.train.batch_size
    shard = Shard(torch.distributed.group.WORLD, slice(0, n), n, replicated=False)
    step = make_train_step("st", rot_impl=cfg.train.rot_impl)
    with no_tf32():
        runs = [one_step_grads(create_train_state(cfg.model, cfg.train, "cuda"),
                               lambda st, sh=sh: step(st, batch, draws, None, sh))
                for sh in (None, shard)]

    def exact():
        twin = create_train_state(dataclasses.replace(cfg.model, attn_backend="xla"),
                                  cfg.train, "cuda").model
        images = augment.train_augment_inline(batch["image_u8"], draws).double()

        def forward(m):
            image, spot = m({"image": images, "expression": batch["expression"].double(),
                             "position": batch["position"]})
            return xent64(spot @ image.T / cfg.model.temperature,
                          torch.eye(n, dtype=torch.float64, device="cuda"))

        return fp64_grads(twin, forward)

    with no_tf32():
        check_grads("one data-parallel step", runs[1], runs[0], exact)


RING_ATOL = 2e-5  # outputs against dense attention
RING_GRAD_RTOL = 1e-4  # of each gradient tensor's largest magnitude


def _attention_with_grads(fn, q, k, v, g):
    """fn(q, k, v) and its q, k, v gradients for the upstream ``g``."""
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(g)
    return out.detach(), (q.grad, k.grad, v.grad)


def _check_attention(what, got, want):
    """Output within RING_ATOL, each gradient within RING_GRAD_RTOL of its
    tensor's largest magnitude."""
    out_err = float((got[0] - want[0]).abs().max())
    grad_errs = [float((a - b).abs().max()) / float(b.abs().max())
                 for a, b in zip(got[1], want[1])]
    assert out_err <= RING_ATOL and max(grad_errs) <= RING_GRAD_RTOL, (what, out_err, grad_errs)


def test_ring_attention_matches_dense(flash_fold, group):
    """``ring_self_attention`` over the one-rank group at the spot tower's
    (n, 8, 64), n = 128 and 4,096, and the block merge over 4 blocks of one
    sequence at n = 4,096 (``blockwise_self_attention``, the ring's schedule
    rotated by indexing), forward and backward against
    ``dense_reference_attention`` (TF32 off)."""
    from mclstexp_tpu_torch.parallel import ring_attention as ring

    m = flash_fold.cfg.model
    world = torch.distributed.group.WORLD
    g = torch.Generator(device="cuda").manual_seed(17)
    for n in (128, 4096):
        q, k, v, up = (torch.randn((n, m.heads_num, m.heads_dim), generator=g, device="cuda")
                       for _ in range(4))
        with no_tf32():
            want = _attention_with_grads(ring.dense_reference_attention, q, k, v, up)
            _check_attention(f"the ring at n = {n}", _attention_with_grads(
                lambda a, b, c: ring.ring_self_attention(a, b, c, world), q, k, v, up), want)
            if n == 4096:
                _check_attention("the block merge over 4 blocks", _attention_with_grads(
                    lambda a, b, c: ring.blockwise_self_attention(a, b, c, 4), q, k, v, up),
                    want)


def _check_spot_grads(got, want, xla_model, img_emb, batch) -> None:
    """The ring's spot-tower gradients against the "xla" model's: each tensor
    within GRAD_RTOL of its largest magnitude, or else held to a float64
    evaluation (the "xla" twin in float64, the loss in float64): no farther
    from it than DP_GRAD_ILL_FACTOR times the "xla" gradient's distance
    (the softmax backward's rowsum cancels in a peaked row, and the ring
    forms it as rowsum(dout * out), the plain backward as sum(p * dp))."""
    import copy

    assert set(got) == set(want) and any("spot_encoder" in k for k in got), sorted(got)
    exact = None
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max()) / scale
        if err <= GRAD_RTOL:
            continue
        if exact is None:
            twin = copy.deepcopy(xla_model).double().train()
            spot = twin.encode_spots(batch["expression"].double(), batch["position"])
            n = len(spot)
            xent64(spot @ img_emb.double().T / twin.config.temperature,
                   torch.eye(n, dtype=torch.float64, device=spot.device)).backward()
            exact = {k: p.grad for k, p in twin.named_parameters() if p.grad is not None}
        plain = float((w.double() - exact[name]).abs().max()) / scale
        mine = float((got[name].double() - exact[name]).abs().max()) / scale
        assert mine <= max(DP_GRAD_ILL_FACTOR * plain, GRAD_RTOL), (name, err, plain, mine)


def test_sequence_and_tensor_parallel_steps(flash_fold, flagship, group):
    """The flagship step under a (1, 1) ("data", "seq") mesh with
    attn_backend "ring" (its spot-tower gradients against "xla",
    ``_check_spot_grads``; 2 steps: the shears, no flash launch) and under a
    (1, 1) ("data", "model") mesh after ``shard_train_state`` with "flash"
    (no DTensor on a "model" axis of 1; 2 steps: the shears and head_layers
    flash launches of each kernel a step; at model 1 ``shard_params``
    replicates, as JAX's does, so its first loss is the data-parallel
    step's)."""
    from torch.distributed.tensor import DTensor

    from mclstexp_tpu_torch.parallel import tp
    from mclstexp_tpu_torch.parallel.mesh import active_mesh, make_mesh
    from mclstexp_tpu_torch.train.step import batch_shard

    fcfg = flash_fold.cfg
    m = fcfg.model
    rcfg = fcfg.replace(model=dataclasses.replace(m, attn_backend="ring"))
    seq_mesh = make_mesh((1, 1), ("data", "seq"), device="cuda")
    model_mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    batch, draws = _step_batch(fcfg, flagship.sections)
    shard = batch_shard(seq_mesh, fcfg.train.batch_size)
    dp_state = create_train_state(m, fcfg.train, "cuda")
    ring_state = create_train_state(rcfg.model, rcfg.train, "cuda")
    tp_state = tp.shard_train_state(create_train_state(m, fcfg.train, "cuda"), model_mesh)
    assert not any(isinstance(p, DTensor) for p in tp_state.model.parameters())

    xla_model = MclSTExp(dataclasses.replace(m, attn_backend="xla"), device="cuda")
    xla_model.load_state_dict(ring_state.model.state_dict())
    with torch.no_grad():
        img_emb = ring_state.model.eval().encode_image(
            augment.train_augment_inline(batch["image_u8"], draws))
    with no_tf32():
        with active_mesh(seq_mesh):
            got = _spot_grads(ring_state.model, img_emb, batch)
        want_grads = _spot_grads(xla_model, img_emb, batch)
        _check_spot_grads(got, want_grads, xla_model, img_emb, batch)
    ring_state.model.zero_grad(set_to_none=True)
    del xla_model, img_emb, got, want_grads

    step = make_train_step("st", rot_impl=fcfg.train.rot_impl)
    runs = {}
    for name, state, mesh in (("dp", dp_state, seq_mesh), ("ring", ring_state, seq_mesh),
                              ("tp", tp_state, model_mesh)):
        reset_counts()
        with active_mesh(mesh):
            step_losses = [float(step(state, batch, draws, None, shard)) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(math.isfinite(v) for v in step_losses), (name, step_losses)
        runs[name] = (step_losses, flash_counts(), dict(row_shift.kernel_launches))
    want = m.head_layers * 2
    assert runs["ring"][1:] == ((0, 0, 0), shear_launches(2)), runs["ring"]
    assert runs["tp"][1:] == ((want, want, want), shear_launches(2)), runs["tp"]
    assert runs["tp"][0][0] == runs["dp"][0][0], (runs["tp"][0], runs["dp"][0])
