"""Hist2ST in the port against the benchmark's plain reference
(``benchmark/reference/hist2st.py``), on the CPU at a tiny size: 28-px
images (the program's widths follow: 32 channels, dim 64, 2 / 8 / 4
blocks, 16 heads of 64), 8 genes, a 6 x 6 grid padded to 48 rows, weights
drawn from a seed, dropout 0.2 and 5 bakes as the cell runs them.

Tolerances, both sides fp32: outputs, losses and gradients are the same
sums in another order (the program's dense neighbour mean against the
reference's edge list, cuDNN-free convolutions, a fused LSTM against its
written-out gates), so they agree to a few float32 ulps of the largest
terms: outputs atol 2e-5 (values of order 1), losses rtol 1e-5, each
gradient within 1e-4 of its largest element, the biases whose gradient is
zero up to rounding (a batch norm follows them; coef's last bias adds the
same to every bake before the softmax) below 1e-5 of the largest gradient,
each leaf's change after three Adam steps within 1e-3 of its norm (the
near-zero ones left out: Adam moves them by round-off alone). A program
that leaves the bakes or the counts out moves the loss past its tolerance
(the bakes' term is ~1e-4 of the loss at these weights) and leaves the
heads that only that term trains without a gradient.

Also here: the ranges a step shows to the profiler, and the refusal of a
fold checkpoint written while the LSTM's fixed biases were frozen
parameters.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import data
from benchmark.harness import BENCH, load_json, load_module
from mclstexp_tpu_torch.baselines import trainer
from mclstexp_tpu_torch.core.layers import seed_dropout
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.train import checkpoint
from mclstexp_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

REF = load_module("reference", "hist2st")
BUILD = load_module("configs", "hist2st")
CFG = dict(load_json(BENCH / "configs" / "hist2st.json"), n_genes=8, patch_size=28, dim=64,
           mlp_dim=64, bucket=16)
SEED, SIDE = 2**31 + 17, 6
NEAR_ZERO = tuple(f"vit.transformer.layer1.{i}.dw.{j}.bias" for i in (0, 1) for j in (0, 3)) + \
    ("coef.2.bias",)
OUT_ATOL, LOSS_RTOL, GRAD_TOL, CHANGE_TOL = 2e-5, 1e-5, 1e-4, 1e-3


@pytest.fixture(scope="module")
def slide():
    """The real rows and the program's padded batch of one 6 x 6 slide."""
    real = data.spots([SIDE * SIDE], CFG["patch_size"], CFG["n_genes"], SEED, "cpu")
    return real, BUILD.slide_batch(real, CFG["bucket"])


def _program(cfg=CFG):
    weights = BUILD.weights(cfg, SEED, "cpu")
    return weights, BUILD.train_state(cfg, weights, "cpu")


def _generator(key=0):
    return augment.reseed(torch.Generator(), SEED, key)


def _graph(real):
    return REF.spot_graph(CFG, real["position"])


def test_forward_matches_the_reference(slide):
    """The four outputs of a train-mode pass on the real rows, plain and
    baked (``aug``: coef in place of h), dropout drawn alike."""
    real, batch = slide
    weights, state = _program()
    model, n = state.model.train(), SIDE * SIDE
    images = augment.to_float(batch["patches"])
    for aug in (False, True):
        seed_dropout(model, _generator(int(aug)))
        with torch.no_grad():
            got = model(images, batch["positions"], batch["adj"], mask=batch["mask"], aug=aug)
            want = REF.forward(weights, CFG, images[:n], real["position"], _graph(real),
                               REF.dropout_keeps(CFG, _generator(int(aug)), n), aug)
        pairs = [(got[0], want[0]), *zip(got[1], want[1]), (got[2], want[2])]
        for name, (g, w) in zip(("pred", "mean", "disp", "pi", "coef" if aug else "h"), pairs):
            torch.testing.assert_close(g[:n], w, rtol=0, atol=OUT_ATOL, msg=name)


def _program_loss(state, batch, cfg=CFG):
    return trainer.slide_loss(state.model, BUILD.baseline_config(cfg), batch, _generator())


def _reference_loss(weights, real, keys=()):
    P = {k: v.clone().requires_grad_(k in keys) for k, v in weights.items()}
    loss = REF.slide_loss(P, CFG, real, _generator(), _graph(real))
    return loss, dict(zip(keys, torch.autograd.grad(loss, [P[k] for k in keys]))) if keys else {}


def test_loss_and_every_gradient_match_the_reference(slide):
    """One step's loss (MSE + 0.25 ZINB + 0.5 x the distillation over 5
    bakes) and the gradient of every trained parameter; the fixed LSTM
    biases have none on either side."""
    real, batch = slide
    weights, state = _program()
    loss = _program_loss(state, batch)
    loss.backward()
    keys = [k for k, _ in state.model.named_parameters()]
    assert not set(keys) & set(REF.FIXED) and set(keys) == \
        set(data.trainable(REF.parameter_specs(CFG))) - set(REF.FIXED)
    want_loss, want = _reference_loss(weights, real, keys)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    grads = dict(state.model.named_parameters())
    scale = max(float(g.abs().max()) for g in want.values())
    for k in keys:
        got, w = grads[k].grad, want[k]
        if k in NEAR_ZERO:
            assert max(float(got.abs().max()), float(w.abs().max())) < 1e-5 * scale, k
        else:
            torch.testing.assert_close(got, w, rtol=0, atol=GRAD_TOL * float(w.abs().max()),
                                       msg=k)


def test_three_adam_steps_match_the_reference(slide):
    """The program's step three times on the slide, each step's dropout and
    bakes keyed as the benchmark keys them, against the reference's Adam:
    every loss and every leaf's change."""
    real, batch = slide
    weights, state = _program()
    start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    step = BUILD.train_step(CFG)
    losses = [float(step(state, batch, _generator(t))) for t in range(3)]
    keys = data.trainable(REF.parameter_specs(CFG))
    want = REF.train_steps(weights, keys, CFG, [real] * 3, [_generator(t) for t in range(3)])
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
    assert state.step == 3 and set(want["change_norms"]) == set(start)
    for k, p in state.model.named_parameters():
        if k in NEAR_ZERO:  # Adam moves a zero gradient by its round-off alone
            continue
        change = float((p.detach() - start[k]).norm())
        assert abs(change - want["change_norms"][k]) <= CHANGE_TOL * want["change_norms"][k], k


@pytest.mark.parametrize("fault", ["bake 0", "no counts"])
def test_program_without_bakes_or_counts_differs(slide, fault):
    """Without the bakes' term, or without the counts' ZINB term, the loss
    falls outside its tolerance and the heads that only that term trains
    (coef; mean, disp and pi) get no gradient."""
    real, batch = slide
    weights, state = _program()
    bcfg = BUILD.baseline_config(CFG)
    if fault == "bake 0":
        bcfg = dataclasses.replace(bcfg, bake=0)
    else:
        batch = {k: v for k, v in batch.items() if k not in ("counts", "size_factors")}
    loss = trainer.slide_loss(state.model, bcfg, batch, _generator())
    loss.backward()
    keys = [k for k, _ in state.model.named_parameters()]
    want_loss, want = _reference_loss(weights, real, keys)
    assert abs(float(loss.detach()) - float(want_loss)) > 5 * LOSS_RTOL * float(want_loss)
    params = dict(state.model.named_parameters())
    off = {k for k in keys if params[k].grad is None or not torch.allclose(
        params[k].grad, want[k], rtol=0, atol=GRAD_TOL * float(want[k].abs().max()))}
    heads = ("coef.",) if fault == "bake 0" else ("mean.", "disp.", "pi.")
    assert {k for k in keys if k.startswith(heads)} <= off


def _ranges(step_fn) -> collections.Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn()
    return collections.Counter(e.name for e in prof.events()
                               if e.name in ("slide_step", "bake", "convmixer", "graph", "jknet"))


def test_a_step_shows_its_passes_to_the_profiler(slide):
    """A Hist2ST step: one ``slide_step``, five ``bake`` ranges, and the
    six passes' ``convmixer``, ``graph`` and ``jknet``; a HisToGene step
    none of Hist2ST's ranges."""
    _, batch = slide
    _, state = _program()
    step = BUILD.train_step(CFG)
    assert _ranges(lambda: step(state, batch, _generator())) == \
        {"slide_step": 1, "bake": 5, "convmixer": 6, "graph": 6, "jknet": 6}
    hcfg = trainer.BaselineConfig(model="histogene", n_genes=8, patch_size=8, n_layers=1,
                                  bucket=16)
    model = trainer.build_baseline(hcfg, "cpu", "flash")
    hstate = TrainState(model, trainer.baseline_optimizer(hcfg, model.parameters()))
    real = data.spots([20], 8, 8, SEED, "cpu")
    hbatch = load_module("configs", "histogene").slide_batch(real, 16)
    assert _ranges(lambda: trainer.make_slide_step(hcfg)(hstate, hbatch, _generator())) == \
        {"slide_step": 1}


def test_a_checkpoint_from_when_the_biases_were_frozen_parameters_resumes(slide, tmp_path):
    """A fold checkpoint whose optimizer state lists the LSTM's two
    ``bias_hh`` among the parameters (frozen, without moments) does not
    resume: it is refused with a message that names the fixed biases, and
    the same fold's checkpoint in the layout of now resumes."""
    _, batch = slide
    _, old = _program()
    t = old.model.vit.transformer
    lstm = torch.nn.LSTM(CFG["dim"], CFG["dim"], 2)  # the layout before: frozen parameters
    lstm.load_state_dict(t.jknet[0].state_dict())
    for layer in range(2):
        getattr(lstm, f"bias_hh_l{layer}").requires_grad_(False)
    t.jknet = torch.nn.ModuleList([lstm])
    old = TrainState(old.model, trainer.baseline_optimizer(BUILD.baseline_config(CFG),
                                                           old.model.parameters()))
    BUILD.train_step(CFG)(old, batch, _generator())
    assert len(old.optimizer.state_dict()["param_groups"][0]["params"]) == \
        len(list(old.model.parameters())) == len(list(_program()[1].model.parameters())) + 2
    checkpoint.save_checkpoint(str(tmp_path / "before"), old)
    _, new = _program()
    with pytest.raises(ValueError, match="bias_hh_l0 and bias_hh_l1 were frozen parameters"):
        checkpoint.apply_checkpoint(new, checkpoint.restore_checkpoint(str(tmp_path / "before")))
    _, now = _program()
    BUILD.train_step(CFG)(now, batch, _generator())
    checkpoint.save_checkpoint(str(tmp_path / "now"), now)
    _, new = _program()
    checkpoint.apply_checkpoint(new, checkpoint.restore_checkpoint(str(tmp_path / "now")))
    before = dict(now.model.named_parameters())
    for name, p in new.model.named_parameters():
        torch.testing.assert_close(p, before[name], rtol=0, atol=0)
        torch.testing.assert_close(new.optimizer.state[p]["exp_avg"],
                                   now.optimizer.state[before[name]]["exp_avg"], rtol=0, atol=0)
    assert new.step == 1
