"""The slide baselines and BLEEP on the card.

These tests need an NVIDIA card and skip without one:

    python -m pytest --noconftest tests/test_torch_port_card_baselines.py -m gpu

HisToGene, THItoGene and Hist2ST at their reference widths (785 genes,
112-px patches) with "flash" on four synthetic her2st-like sections of 346,
613, 705 and 524 spots (fold 0 holds out the first): the segment kernels'
launches a slide step, flash against "xla" gradients on one padded slide,
``predict_slide`` against the CPU, the whole-slide step (3,969 spots in
4,096 rows) on the fp32 warpgroup kernels and the 3xTF32 linear kernel; the
same families in bf16. BLEEP (resnet50, 224 px, batch 128) on the her2st
flagship's three sections of 225 spots: its fold, its embeddings against the
CPU, the three retrieval modes, its step over a one-rank NCCL group against
the step without one, and a bf16 step.
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_port_card import (GRAD_RTOL, bleep_cfg, card,  # noqa: F401
                              check_grads, flagship_sections, flash_counts, fp64_grads, losses,
                              no_tf32, one_step_grads, reset_counts, xent64)
from mclstexp_tpu_torch.baselines import trainer
from mclstexp_tpu_torch.config import her2st_config
from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops import flash_attention as fa
from mclstexp_tpu_torch.ops.linear import linear_fp32
from mclstexp_tpu_torch.utils.logging import MetricLogger

pytestmark = pytest.mark.gpu

BASELINE_SPOTS = (346, 613, 705, 524)  # her2st-like sections; fold 0 holds out the first
WHOLE_SLIDE = 63  # a 63 x 63 grid: 3,969 spots, padded to 4,096
LINEAR_STEP = (34, 67)  # HisToGene's products a whole-slide step: forward, backward
HIST2ST_LINEAR_STEP = 245 + 460  # Hist2ST's: 6 passes and their backward
HIST2ST_PER_STEP = 48  # 6 train-mode passes (the slide, 5 bakes) x 8 attention layers


@pytest.fixture(scope="module")
def sections(card):
    """Four synthetic sections at 112 px (``make_section``, a seed, shared
    gene loadings); positions on a grid, all below the 64-entry tables."""
    from mclstexp_tpu_torch.data import synthetic

    loadings = np.random.default_rng(30).normal(size=(4, 785))
    return [synthetic.make_section(f"B{i + 1}", n, 785, patch_size=112, seed=300 + i,
                                   gene_loadings=loadings)
            for i, n in enumerate(BASELINE_SPOTS)]


@pytest.fixture(scope="module")
def whole_slide(card):
    """One 63 x 63-spot slide (3,969 spots, 4,096 rows) of random patches,
    expression and counts, from a seed."""
    from mclstexp_tpu_torch.data.section import Section

    n = WHOLE_SLIDE * WHOLE_SLIDE
    rng = np.random.default_rng(31)
    grid = np.stack(np.meshgrid(np.arange(WHOLE_SLIDE), np.arange(WHOLE_SLIDE)), -1)
    grid = grid.reshape(-1, 2).astype(np.int32)
    return Section("whole", rng.normal(size=(n, 785)).astype(np.float32), grid, grid,
                   patches=rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8),
                   counts=rng.poisson(2.0, (n, 785)).astype(np.float32))


def _fold(cfg, sections, per_step: int, prefix: str = ""):
    """train_baseline_fold with attn_backend="flash", the counts set to 0
    just before it and read just after: ``per_step`` launches of each
    kernel a slide step, all of them with segment ids; the fp32 kernels, or
    with ``prefix`` "bf16_" the bf16 ones (and then none of the fp32 ones)."""
    logger = MetricLogger(echo=False)
    reset_counts()
    state = trainer.train_baseline_fold(cfg, sections, 0, logger=logger, device="cuda",
                                        attn_backend="flash")
    torch.cuda.synchronize()
    steps = len(sections) - 1
    want = (per_step * steps,) * 3
    counts, segments = flash_counts(prefix=prefix), flash_counts(True, prefix=prefix)
    assert state.step == steps and counts == want and segments == want, (counts, segments)
    assert not prefix or flash_counts() == (0, 0, 0), flash_counts()
    losses(logger)
    return state


def _slide_grads(model, cfg, batch):
    """The slide loss's gradients, dropout and Hist2ST's bakes drawn from one
    fixed key, so two models of one family draw the same."""
    model.zero_grad(set_to_none=True)
    trainer.slide_loss(model, cfg, batch, augment.reseed(torch.Generator(device="cuda"), 0, 1)
                       ).backward()
    return {name: p.grad.clone() for name, p in model.named_parameters() if p.grad is not None}


def _fp64_slide_grads(model, cfg, batch):
    """The slide loss's gradients from a float64 copy of ``model`` on the same
    inputs (the patches as the fp32 models see them, then widened) and the
    same draws."""
    twin = copy.deepcopy(model).double()
    wide = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    to_float = augment.to_float
    augment.to_float = lambda u: to_float(u).double()
    try:
        return _slide_grads(twin, cfg, wide)
    finally:
        augment.to_float = to_float


def _flash_vs_xla_grads(flash_model, cfg, batch, near_zero=()):
    """One padded slide's gradients through ``flash_model`` against a model
    with "xla" attention and the same weights, TF32 off: every tensor within
    GRAD_RTOL of its largest magnitude. Where the two part further (a small
    sum of large terms, such as a position table's gradient, keeps their
    rounding), the flash gradient must lie no farther from a float64
    evaluation of the "xla" model than twice the xla gradient does, or
    within GRAD_RTOL of it. Those named with a suffix in ``near_zero``, whose
    gradient is zero up to rounding, must lie below 1e-5 of the largest
    gradient on both sides."""
    xla = trainer.init_baseline(cfg, "cuda", "xla")
    xla.model.load_state_dict(flash_model.state_dict())
    # Both gradients from deterministic algorithms: with the default ones a
    # reduction upstream of Hist2ST's position tables (a small sum of large
    # terms) leaves one of the two fp32 paths, either, by chance, 1.5e-4
    # from float64, where the other lies within 2e-5.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with no_tf32():  # TF32 convolutions would round the two models' gradients apart
            got, want = _slide_grads(flash_model, cfg, batch), _slide_grads(xla.model, cfg, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    trained = [p for p in flash_model.parameters() if p.requires_grad]
    assert set(got) == set(want) and len(got) == len(trained), sorted(got)
    far = {}
    largest = max(float(g.abs().max()) for g in want.values())
    for name, gr in got.items():
        if name.endswith(near_zero):
            small = max(float(gr.abs().max()), float(want[name].abs().max()))
            assert small < 1e-5 * largest, (name, small, largest)
            continue
        scale = float(want[name].abs().max())
        err = float((gr - want[name]).abs().max()) / max(scale, 1e-30)
        assert torch.isfinite(gr).all(), name
        if err > GRAD_RTOL:
            far[name] = err
    if far:
        with no_tf32():
            exact = _fp64_slide_grads(xla.model, cfg, batch)
        for name, err in far.items():
            e = exact[name]
            scale = max(float(e.abs().max()), 1e-30)
            flash_err = float((got[name].double() - e).abs().max()) / scale
            xla_err = float((want[name].double() - e).abs().max()) / scale
            assert flash_err <= max(GRAD_RTOL, 2 * xla_err), (name, err, flash_err, xla_err)


def test_histogene_fold(sections):
    """HisToGene (dim 1,024, 8 layers, 16 x 64 heads, mlp 2,048) with
    "flash": 8 segment launches of each kernel a slide step, dK/dV's at the
    training slides' buckets (640 and 768 rows: 80 and 96 CTAs of 128 keys)
    on 128-key CTAs (``fp32_plan``); one padded
    slide's gradients against "xla"; ``predict_slide`` on the held-out
    section within 1e-3 of the CPU's; finite fold metrics."""
    cfg = trainer.BaselineConfig(model="histogene", n_genes=785, patch_size=112, n_layers=8,
                                 max_epochs=1)
    state = _fold(cfg, sections, 8)
    assert fa.flash_bwd_dkv.wg128_launches == 8 * (len(sections) - 1), (
        fa.flash_bwd_dkv.wg128_launches)
    batch = trainer.slide_tensors(trainer.pad_slide(sections[2], cfg.bucket, False, cfg), "cuda")
    _flash_vs_xla_grads(state.model, cfg, batch)
    test = sections[0]
    cpu = trainer.build_baseline(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()})
    pred = trainer.predict_slide(state.model, test, cfg)
    err = float(np.abs(pred - trainer.predict_slide(cpu, test, cfg)).max())
    assert pred.shape == (test.num_spots, 785) and err <= 1e-3, (pred.shape, err)
    metrics = trainer.evaluate_baseline_fold(cfg, sections, 0, state.model)
    assert all(math.isfinite(v) for v in metrics.values()), metrics


def test_to_float_eager_is_the_true_division(card):
    """``predict_slide``'s eager scaling on the card: a true division by 255,
    as on the CPU, over all 256 values."""
    u8 = torch.arange(256, dtype=torch.uint8)
    want = (u8.float() / torch.tensor(255.0)).numpy().view(np.uint32)
    got = trainer.to_float_eager(u8.cuda()).cpu().numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_thitogene_fold(sections):
    """THItoGene (4 layers, caps 20 x 64, ViT width 1,408, heads (16, 8)):
    4 segment launches of each kernel a slide step; a finite prediction."""
    cfg = trainer.BaselineConfig(model="thitogene", n_genes=785, patch_size=112, n_layers=4,
                                 max_epochs=1)
    state = _fold(cfg, sections, 4)
    pred = trainer.predict_slide(state.model, sections[0], cfg)
    assert pred.shape == (sections[0].num_spots, 785) and np.isfinite(pred).all()


def test_histogene_whole_slide_step(whole_slide):
    """One 4,096-row HisToGene step (attention (1, 16, 4096, 64) a layer):
    34 linear products on the 3xTF32 kernel in the forward and 67 in the
    backward; a train step with "flash" and one with "xla", each 101
    products, the flash step 8 launches of each flash kernel, all on the
    warpgroup design (``fp32_plan``), dK/dV's on 128-key CTAs."""
    cfg = trainer.BaselineConfig(model="histogene", n_genes=785, patch_size=112, n_layers=8,
                                 max_epochs=1)
    batch = trainer.slide_tensors(trainer.pad_slide(whole_slide, cfg.bucket, False, cfg), "cuda")
    xla = trainer.init_baseline(cfg, "cuda", "xla")
    flash = trainer.init_baseline(cfg, "cuda", "flash")
    reset_counts()
    loss = trainer.slide_loss(flash.model, cfg, batch,
                              augment.reseed(torch.Generator(device="cuda"), 0, 1))
    linear = [linear_fp32.wg_launches]
    loss.backward()
    linear.append(linear_fp32.wg_launches - linear[0])
    flash.model.zero_grad(set_to_none=True)
    del loss
    assert tuple(linear) == LINEAR_STEP, linear
    step = trainer.make_slide_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_counts()
    for state in (flash, xla):
        assert math.isfinite(float(step(state, batch, gen)))
    torch.cuda.synchronize()
    wg = tuple(w.wg_launches for w in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq))
    assert wg == (8, 8, 8) and flash_counts() == wg, (wg, flash_counts())
    assert fa.flash_bwd_dkv.wg128_launches == 8, fa.flash_bwd_dkv.wg128_launches
    assert linear_fp32.wg_launches == 2 * sum(LINEAR_STEP), linear_fp32.wg_launches


def test_hist2st_fold(sections):
    """Hist2ST (dim 1,024, depths 2 / 8 / 4, zinb 0.25, bake 5, lamb 0.5)
    with "flash": 48 segment launches of each kernel a slide step (the slide
    and 5 bakes through 8 layers); one slide's gradients against "xla"
    (the conv biases before a batch norm and coef's last bias, which adds the
    same to every bake before their softmax, zero up to rounding);
    ``predict_slide`` with TF32 off within 1e-3 of the CPU's, 8 forward
    segment launches and no backward; finite fold metrics."""
    cfg = trainer.BaselineConfig(model="hist2st", n_genes=785, patch_size=112, max_epochs=1)
    model = _fold(cfg, sections, HIST2ST_PER_STEP).model
    batch = trainer.slide_tensors(trainer.pad_slide(sections[2], cfg.bucket, True, cfg), "cuda")
    _flash_vs_xla_grads(model, cfg, batch, near_zero=(".dw.0.bias", ".dw.3.bias", "coef.2.bias"))
    test = sections[0]
    cpu = trainer.build_baseline(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    reset_counts()
    with no_tf32():
        pred = trainer.predict_slide(model, test, cfg)
    assert flash_counts(segments=True) == (8, 0, 0), flash_counts(segments=True)
    err = float(np.abs(pred - trainer.predict_slide(cpu, test, cfg)).max())
    assert pred.shape == (test.num_spots, 785) and err <= 1e-3, (pred.shape, err)
    metrics = trainer.evaluate_baseline_fold(cfg, sections, 0, model)
    assert all(math.isfinite(v) for v in metrics.values()), metrics


def test_hist2st_whole_slide_step(whole_slide):
    """One 4,096-row Hist2ST step (6 passes of 8 layers of attention (1, 16,
    4096, 64) with ids): 705 linear products on the kernel."""
    cfg = trainer.BaselineConfig(model="hist2st", n_genes=785, patch_size=112, max_epochs=1)
    batch = trainer.slide_tensors(trainer.pad_slide(whole_slide, cfg.bucket, True, cfg), "cuda")
    state = trainer.init_baseline(cfg, "cuda", "flash")
    reset_counts()
    loss = trainer.make_slide_step(cfg)(state, batch, torch.Generator(device="cuda").manual_seed(0))
    assert math.isfinite(float(loss))
    assert linear_fp32.wg_launches == HIST2ST_LINEAR_STEP, linear_fp32.wg_launches


@pytest.fixture(scope="module")
def flagship(card):
    """The her2st flagship's three sections of 225 spots at 224 px."""
    return flagship_sections(her2st_config())


def test_bleep_fold(flagship):
    """``train_bleep_fold`` for fold 0 (4 epochs of 450 spots, each 3 batches
    and a remainder); ``bleep_embeddings`` of every spot, finite, the
    held-out section's within 1e-3 of the CPU's (TF32 off); fold 0 in the
    three retrieval modes, finite, the HEG PCC NaN only where a HEG is
    predicted constant over the queries (a Pearson r without a spread, as
    when the top-1 keys of every query are a handful of spots)."""
    from mclstexp_tpu_torch.infer import embed, evaluate, metrics
    from mclstexp_tpu_torch.ops import retrieval

    cfg = bleep_cfg()
    logger = MetricLogger(echo=False)
    state = trainer.train_bleep_fold(cfg, flagship, 0, logger=logger, device="cuda")
    torch.cuda.synchronize()
    epochs = losses(logger)
    steps = -(-sum(s.num_spots for s in flagship[1:]) // cfg.batch_size) * len(epochs)
    assert state.step == steps, (state.step, steps)

    img, spot = trainer.bleep_embeddings(state.model, flagship)
    sizes = [s.num_spots for s in flagship]
    assert img.shape == (sum(sizes), 256) and np.isfinite(img).all() and np.isfinite(spot).all()
    cpu = trainer.build_baseline(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()})
    with no_tf32():
        card_emb = trainer.bleep_embeddings(state.model, flagship[:1])
    errs = [float(np.abs(g - w).max())
            for g, w in zip(card_emb, trainer.bleep_embeddings(cpu, flagship[:1]))]
    assert max(errs) <= 1e-3, errs
    hegs = metrics.heg_indices(flagship[0].eval_expression)
    for top_k, weight_ord in ((1, 0), (50, 0), (50, -1)):
        result = evaluate.evaluate_fold(
            0, embed.split_by_section(img, sizes)[0], embed.split_by_section(spot, sizes),
            [s.eval_expression for s in flagship], top_k=top_k, weight_ord=weight_ord,
            device="cuda")
        _, pred = retrieval.retrieve_and_aggregate(
            np.concatenate(embed.split_by_section(spot, sizes)[1:]),
            np.concatenate([s.eval_expression for s in flagship[1:]]),
            embed.split_by_section(img, sizes)[0], top_k=top_k, weight_ord=weight_ord,
            device="cuda")
        flat_hegs = int((pred[:, hegs].std(axis=0) == 0).sum())
        assert math.isfinite(result["heg_pcc"]) or flat_hegs > 0, (top_k, weight_ord, result)
        assert all(math.isfinite(result[k]) for k in ("hvg_pcc", "mse", "mae")), result


def test_bleep_over_a_one_rank_group(flagship):
    """BLEEP's fold with a one-rank NCCL mesh (one epoch, 4 steps, finite
    losses), and its step's loss and gradients against the step without a
    mesh from the same weights, batch and dropout draws (TF32 off), as
    ``check_grads`` holds them; the group destroyed after."""
    from mclstexp_tpu_torch.core.layers import seed_dropout
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.parallel.mesh import make_mesh
    from mclstexp_tpu_torch.train.step import Shard

    cfg = bleep_cfg(max_epochs=1)
    logger = MetricLogger(echo=False)
    try:
        state = trainer.train_bleep_fold(cfg, flagship, 0, logger=logger, device="cuda",
                                         mesh=make_mesh(device="cuda"))
        torch.cuda.synchronize()
        losses(logger)
        assert state.step == 4, state.step
        data = DeviceResidentData(ConcatSections.from_sections(flagship[1:]), "cuda")
        batch = data.take(np.arange(cfg.batch_size))
        n = cfg.batch_size
        shard = Shard(torch.distributed.group.WORLD, slice(0, n), n, replicated=False)
        step = trainer.make_bleep_step(cfg)

        def dropout():
            return augment.reseed(torch.Generator(device="cuda"), 0, 0)

        with no_tf32():
            runs = [one_step_grads(trainer.init_baseline(cfg, "cuda"),
                                   lambda st, sh=sh: step(st, batch, dropout(), sh))
                    for sh in (None, shard)]

        def exact():
            images = augment.to_float(batch["image_u8"]).double()

            def forward(m):
                seed_dropout(m, dropout())
                image, spot = m({"image": images, "expression": batch["expression"].double()})
                t = cfg.temperature
                targets = torch.softmax((image @ image.T + spot @ spot.T) / 2.0 / t, dim=-1)
                return xent64(spot @ image.T / t, targets)

            return fp64_grads(trainer.init_baseline(cfg, "cuda").model, forward)

        with no_tf32():
            check_grads("BLEEP's step over the mesh", runs[1], runs[0], exact)
    finally:
        distributed.shutdown()


# --- bf16 -----------------------------------------------------------------------------------

def test_bf16_histogene_fold_and_whole_slide(sections, whole_slide):
    """HisToGene in bf16 with "flash": 8 bf16 segment launches of each
    kernel a slide step, none in fp32; a bf16 whole-slide step launches the
    bf16 segment kernels."""
    cfg = trainer.BaselineConfig(model="histogene", n_genes=785, patch_size=112, n_layers=8,
                                 max_epochs=1, dtype="bfloat16")
    _fold(cfg, sections, 8, prefix="bf16_")
    batch = trainer.slide_tensors(trainer.pad_slide(whole_slide, cfg.bucket, False, cfg), "cuda")
    reset_counts()
    loss = trainer.make_slide_step(cfg)(trainer.init_baseline(cfg, "cuda", "flash"), batch,
                                        torch.Generator(device="cuda").manual_seed(0))
    assert math.isfinite(float(loss))
    assert flash_counts(segments=True, prefix="bf16_")[0] != 0


@pytest.mark.parametrize("model,per_step", [("thitogene", 4), ("hist2st", HIST2ST_PER_STEP)])
def test_bf16_fold(sections, model, per_step):
    """THItoGene (4 layers) and Hist2ST in bf16 with "flash": bf16 segment
    launches of each kernel a slide step, none in fp32; a finite prediction
    of the held-out section."""
    cfg = trainer.BaselineConfig(model=model, n_genes=785, patch_size=112, max_epochs=1,
                                 dtype="bfloat16")
    if model == "thitogene":
        cfg = dataclasses.replace(cfg, n_layers=4)
    state = _fold(cfg, sections, per_step, prefix="bf16_")
    pred = trainer.predict_slide(state.model, sections[0], cfg)
    assert pred.shape == (sections[0].num_spots, 785) and np.isfinite(pred).all()


def test_bf16_bleep_step(flagship):
    """One BLEEP step in bf16 (resnet50, batch 128): a finite loss, fp32
    parameters."""
    cfg = bleep_cfg(dtype="bfloat16")
    state = trainer.init_baseline(cfg, "cuda")
    batch = DeviceResidentData(ConcatSections.from_sections(flagship[1:]), "cuda").take(
        np.arange(cfg.batch_size))
    loss = float(trainer.make_bleep_step(cfg)(state, batch, torch.Generator(device="cuda")))
    assert math.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
