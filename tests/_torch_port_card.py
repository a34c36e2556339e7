"""Shared pieces of the port's card tests (``tests/test_torch_port_card_*.py``).

The card tests need an NVIDIA card and skip without one (the ``card``
fixture). This module imports no JAX, and nothing here touches the card or
builds a kernel when it is imported.
"""

import contextlib
import copy
import math
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 1e-4  # of each gradient tensor's largest magnitude

# A data-parallel run at world 1 against the run without a group. One step
# from the same weights, batch and draws, TF32 off: the same loss and every
# gradient tensor within DP_GRAD_RTOL of its largest magnitude (the global
# norm's fp32 statistics round otherwise than cuDNN's). Whole folds part
# further at every step, Adam turning a gradient at the rounding floor into
# a step anywhere in (-lr, lr) and cuDNN's TF32 convolutions rounding the
# next inputs at 2^-11: the flagship folds (4 steps in one process; the
# torchrun ``train``'s 14) held to losses within rtol DP_LOSS_RTOL / _LONG,
# every parameter within 2 lr a step, running statistics within
# DP_STAT_RTOL / _LONG of each tensor's largest magnitude.
DP_GRAD_RTOL = 1e-3
DP_GRAD_ILL = 1e-4  # a float32 gradient this far from float64 is ill-conditioned
DP_GRAD_ILL_FACTOR = 10.0
DP_LOSS_RTOL = 2e-3
DP_STAT_RTOL = 2e-2
DP_LOSS_RTOL_LONG = 5e-3
DP_STAT_RTOL_LONG = 1e-1
DP_NORM_RTOL = 1e-4  # one forward's outputs and statistics, TF32 off


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's main path runs on the card")


def reset_counts() -> None:
    """Every kernel wrapper's launch counters set to 0."""
    from mclstexp_tpu_torch.ops import flash_attention as fa
    from mclstexp_tpu_torch.ops.linear import linear_fp32
    from mclstexp_tpu_torch.ops.patches import extract_patches
    from mclstexp_tpu_torch.ops.row_shift import row_shift

    for w in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq):
        w.launches = w.segment_launches = w.bf16_launches = w.bf16_segment_launches = 0
        w.wg_launches = 0
    fa.flash_bwd_dkv.wg128_launches = 0
    linear_fp32.wg_launches = 0
    extract_patches.launches = 0
    row_shift.launches = 0
    row_shift.kernel_launches = dict.fromkeys(row_shift.kernel_launches, 0)


def flash_counts(segments: bool = False, prefix: str = "") -> tuple:
    """The (forward, dK/dV, dQ) launch counts of the fp32 kernels, or with
    ``prefix`` "bf16_" of the bf16 ones."""
    from mclstexp_tpu_torch.ops import flash_attention as fa

    name = prefix + ("segment_launches" if segments else "launches")
    return tuple(getattr(w, name) for w in (fa.flash_attention, fa.flash_bwd_dkv,
                                            fa.flash_bwd_dq))


def shear_launches(steps: int) -> dict:
    """``row_shift.kernel_launches`` after ``steps`` train steps: the Paeth
    rotation's two row shears and one column shear, each on its 16-byte
    kernel."""
    return {"shift_rows": 0, "shift_rows16": 2 * steps, "shift_cols": 0,
            "shift_cols_band": steps}


@contextlib.contextmanager
def no_tf32():
    """cuDNN (convolutions, the LSTM) and cuBLAS without TF32 products: the
    card against the CPU at 1e-3."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def losses(logger) -> list:
    """The step losses a ``MetricLogger`` recorded, each finite."""
    out = [r["loss"] for r in logger.records if "loss" in r]
    assert out and all(math.isfinite(v) for v in out), f"non-finite or missing losses {out}"
    return out


def child_env(**extra) -> dict:
    """This process's environment with the checkout on ``PYTHONPATH``, for a
    child process that imports the port."""
    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path), **extra)


def state_diff(got: dict, want: dict) -> tuple:
    """Two state dicts apart: (the largest |difference| of a parameter
    element, which Adam bounds by 2 lr a step; the largest running-statistic
    difference relative to its tensor's largest magnitude)."""
    param = stat = 0.0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        err = float((got[k].double() - w.double()).abs().max())
        if k.endswith(("running_mean", "running_var")):
            stat = max(stat, err / max(float(w.abs().max()), 1e-30))
        else:
            param = max(param, err)
    return param, stat


def flagship_sections(cfg):
    """Three synthetic sections of 225 spots at ``cfg``'s widths: fold 0
    trains on 450 spots, 3 full batches of 128 and a remainder of 66."""
    from mclstexp_tpu_torch.data import synthetic

    return synthetic.make_dataset(num_sections=3, num_spots=225, num_genes=cfg.model.spot_dim,
                                  patch_size=cfg.data.patch_size, seed=0)


def bleep_cfg(**kw):
    """BLEEP's reference protocol (resnet50, batch 128, AdamW 1e-3, 4 epochs)."""
    from mclstexp_tpu_torch.baselines import trainer

    return trainer.BaselineConfig(model="bleep", n_genes=785, patch_size=224,
                                  encoder_name="resnet50", batch_size=128, **kw)


def xent64(logits, targets):
    """Soft-target cross-entropy in float64, both directions averaged."""
    def one(lg, tg):
        return -(tg * torch.log_softmax(lg, dim=-1)).sum(dim=-1).mean()

    return (one(logits, targets) + one(logits.T, targets.T)) / 2.0


def one_step_grads(state, run) -> tuple:
    """(loss, {parameter: gradient}) of ``run(state)``, one step of a train
    step on ``state``, whose optimizer is replaced by SGD at lr 0 so that
    the gradients stay on the unchanged parameters."""
    from mclstexp_tpu_torch.train.state import TrainState

    model = state.model
    loss = float(run(TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))))
    return loss, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def fp64_grads(model, forward) -> dict:
    """The parameter gradients of ``forward(twin)``, a loss, where ``twin``
    is a float64 copy of ``model`` in train mode."""
    twin = copy.deepcopy(model).double().train()
    forward(twin).backward()
    return {n: p.grad for n, p in twin.named_parameters() if p.grad is not None}


def check_grads(what: str, got: tuple, want: tuple, exact) -> None:
    """The group's (loss, gradients) against the run without a group: the
    loss within 1e-6, every tensor within ``DP_GRAD_RTOL`` of its largest
    magnitude, or else held to ``exact()``, a float64 evaluation of the
    step: its one-process float32 gradient then ill-conditioned (farther
    than ``DP_GRAD_ILL`` from the float64 one: a sum that cancels, such as
    a norm's bias or the weight of the convolution before it, over channels
    whose spread is small against their mean, on these near-uniform
    synthetic patches; cuDNN's algorithm, which the memory free for its
    workspace picks, moves such sums by 1e-3 to 1e-2), and the group's no
    farther from the float64 one than ``DP_GRAD_RTOL`` or
    ``DP_GRAD_ILL_FACTOR`` times the one-process distance, whichever is
    larger: such a sum's float32 error changes by several times with the
    order of its terms (2.1 times on the CPU, tests/test_torch_port_dp.py,
    and 4.4 to 8.1 times on the card). A gradient N times too large or a
    missing term lies ~100% from float64."""
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    assert set(got[1]) == set(want[1]) and loss_err <= 1e-6, \
        f"{what}: loss {got[0]} against {want[0]}"
    ill, fp64 = {}, None
    for name, w in want[1].items():
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[1][name] - w).abs().max()) / scale
        if err <= DP_GRAD_RTOL:
            continue
        fp64 = fp64 or exact()
        one = float((w.double() - fp64[name]).abs().max()) / scale
        grp = float((got[1][name].double() - fp64[name]).abs().max()) / scale
        ill[name] = (err, one, grp)
    bad = {k: v for k, v in ill.items()
           if not (v[1] > DP_GRAD_ILL and v[2] <= max(DP_GRAD_ILL_FACTOR * v[1], DP_GRAD_RTOL))}
    assert not bad, (f"{what}: {len(ill)} of {len(want[1])} gradient tensors apart, {len(bad)} "
                     f"beyond the float64 bounds, each (apart from the run without a group; "
                     f"that run, the group's from a float64 evaluation): "
                     f"{sorted(bad.items(), key=lambda kv: -kv[1][2])[:8]}")
