"""The slide baselines' slide-DP mode on one process against the JAX
package's, on the CPU.

``train_baseline_fold(slides_per_step=D)`` at D = 2 and 3 against JAX's
``train_baseline_fold(slides_per_step=D)`` (``make_slide_dp_step``: D
slides a step, each padded to the training set's largest bucket, the
loss and gradient the mean over the slides, the batch norms' new running
statistics the mean of the slides' updates from the same old ones), for
HisToGene and Hist2ST (zinb, no bakes: the bakes' draws are each package's
own) at narrow widths, dropout 0, from the same initial parameters (JAX's
init carried over). Fold 0 of four sections trains on three slides (20, 9
and 15 spots, all padded to 32): at D = 2 a step of two and one of one, at
D = 3 one step of three, two epochs.

Tolerances, those of ``tests/test_torch_port_train.py``: the epoch losses
rtol 1e-4; the parameters within 2 lr of JAX's (Adam normalizes each step
to about lr, so an element whose gradient is about 0 may step either way
in the two frameworks), and within 2 lr a step for Hist2ST's ``NEAR_ZERO``
biases, whose gradients are zero by invariance up to rounding (Adam steps
them by their rounding's sign, in each framework its own); the running
statistics rtol 1e-4, atol 1e-6, where the running means of the norms
those biases feed (which carry the biases) may add the biases' 2 lr a
step.
"""

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu.baselines import models as jax_models
from mclstexp_tpu.baselines import trainer as jax_trainer
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.utils.logging import MetricLogger as JaxLogger
from mclstexp_tpu_torch import interop
from mclstexp_tpu_torch.baselines import models, trainer
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.train.state import TrainState
from mclstexp_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

G = 8
LR = 1e-5  # the families' reference rate
SPOTS = [12, 20, 9, 15]
PATCH = {"histogene": 16, "hist2st": 28}
# the conv biases that feed a batch norm (tests/test_torch_port_hist2st.py)
NEAR_ZERO = ("vit.transformer.layer1.0.dw.0.bias", "vit.transformer.layer1.0.dw.3.bias")
FED = ("vit.transformer.layer1.0.dw.1.running_mean", "vit.transformer.layer1.0.dw.4.running_mean")


def _models(family):
    """(JAX model, port model on the CPU) at test widths, dropout 0."""
    if family == "histogene":
        kw = dict(dim=32, n_layers=1, heads=2, dropout=0.0)
        return (jax_models.HisToGene(n_genes=G, patch_size=PATCH[family], **kw),
                models.HisToGene(G, PATCH[family], device="cpu", **kw))
    kw = dict(fig_size=PATCH[family], patch_size=7, channel=16, depth1=1, depth2=1, depth3=2,
              heads=2, dropout=0.0, zinb=True)
    return jax_models.Hist2ST(n_genes=G, **kw), models.Hist2ST(G, device="cpu", **kw)


def _sections(patch):
    loadings = np.random.default_rng(0).normal(size=(4, G))
    make = lambda mod: [mod.make_section(f"S{i}", n, G, patch, seed=i,  # noqa: E731
                                         gene_loadings=loadings)
                        for i, n in enumerate(SPOTS)]
    return make(jax_synthetic), make(synthetic)


@pytest.mark.parametrize("slides", [2, 3])
@pytest.mark.parametrize("family", ["histogene", "hist2st"])
def test_slide_dp_matches_jax(family, slides, monkeypatch):
    jmodel, tmodel = _models(family)
    cfg_kw = dict(model=family, n_genes=G, patch_size=PATCH[family], bucket=16, max_epochs=2,
                  lr=LR, bake=0)
    jsecs, tsecs = _sections(PATCH[family])

    created = []
    jax_init = jax_trainer.init_baseline

    def capture(*args, **kw):
        model, state = jax_init(*args, **kw)
        created.append(jax.device_get(state))  # a host copy: training donates the buffers
        return model, state

    monkeypatch.setattr(jax_trainer, "build_baseline", lambda cfg: jmodel)
    monkeypatch.setattr(jax_trainer, "init_baseline", capture)
    jlog = JaxLogger(echo=False)
    _, jstate = jax_trainer.train_baseline_fold(jax_trainer.BaselineConfig(**cfg_kw), jsecs, 0,
                                                logger=jlog, slides_per_step=slides)
    init = created[0]

    def shared_init(cfg, device="cuda", attn_backend="xla"):
        tmodel.load_state_dict(interop.baseline_params_from_jax(
            tmodel, init.params, init.batch_stats), strict=True)
        return TrainState(tmodel, trainer.baseline_optimizer(cfg, tmodel.parameters()))

    monkeypatch.setattr(trainer, "init_baseline", shared_init)
    log = MetricLogger(echo=False)
    state = trainer.train_baseline_fold(trainer.BaselineConfig(**cfg_kw), tsecs, 0, logger=log,
                                        device="cpu", slides_per_step=slides)
    assert state.step == int(jstate.step) == 2 * -(-3 // slides)
    np.testing.assert_allclose([r["loss"] for r in log.records],
                               [r["loss"] for r in jlog.records], rtol=1e-4)
    want = interop.baseline_params_from_jax(tmodel, jax.device_get(jstate.params),
                                            jax.device_get(jstate.batch_stats))
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            atol = 1e-6 + (2 * LR * state.step if k in FED else 0.0)
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=atol,
                                       err_msg=k)
        else:
            atol = 2 * LR * state.step if k in NEAR_ZERO else 2 * LR
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=atol, err_msg=k)
