"""Port parity of the whole slice: data, batches, and the "st" train step.

Both packages start from the same parameters (the JAX init carried over by
``params_from_jax``) and take three steps on the same batches, the port fed
the augmentation draws the JAX step takes from its key. Tolerances:
  * losses rtol 1e-4: fp32 on both sides, summation order differs;
  * parameters atol 2 * lr: Adam normalizes each step to about lr, so an
    element whose first gradient is ~0 may take the opposite sign in the two
    frameworks and land at most ~2 * lr apart;
  * BatchNorm running stats rtol 1e-4, with an atol 1e-6 floor: a running
    mean near 0 (seen down to ~6e-4) is a sum of terms two orders larger,
    so its fp32 rounding is absolute, not relative.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu.config import ModelConfig as JaxModelConfig, TrainConfig as JaxTrainConfig
from mclstexp_tpu.data import pipeline as jax_pipeline, synthetic as jax_synthetic
from mclstexp_tpu.train.state import create_train_state as jax_create_train_state
from mclstexp_tpu.train.step import make_train_step as jax_make_train_step
from mclstexp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mclstexp_tpu_torch.data import pipeline, synthetic
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.train import checkpoint
from mclstexp_tpu_torch.train.loop import check_positions_in_vocab, train_fold
from mclstexp_tpu_torch.train.state import TrainState, torch_adam
from mclstexp_tpu_torch.train.step import make_train_step
from test_torch_port_augment import _jax_st_draws, _shears_agree

torch.set_num_threads(1)

TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, pos_vocab=64, dense_block_impl="concat")
LR = 1e-3


def _sections(**kw):
    return synthetic.make_dataset(num_sections=3, num_spots=20, num_genes=24, patch_size=16,
                                  **kw)


def test_synthetic_sections_match_jax():
    ours = _sections(seed=4)
    theirs = jax_synthetic.make_dataset(num_sections=3, num_spots=20, num_genes=24,
                                        patch_size=16, seed=4)
    for a, b in zip(ours, theirs):
        assert a.name == b.name
        for field in ("expression", "positions", "centers", "patches", "counts"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_train_batches_match_jax():
    """Same permutation from SeedSequence([seed, epoch]), remainder kept, on
    the host and from the device-resident set."""
    train_secs, test_sec = pipeline.split_fold(_sections(), 1)
    jtrain, jtest = jax_pipeline.split_fold(
        jax_synthetic.make_dataset(num_sections=3, num_spots=20, num_genes=24, patch_size=16), 1)
    assert test_sec.name == jtest.name == "S2"
    data = pipeline.ConcatSections.from_sections(train_secs)
    jdata = jax_pipeline.ConcatSections.from_sections(jtrain)
    dev = pipeline.DeviceResidentData(data, "cpu")
    for epoch in (0, 3):
        ours = list(pipeline.train_batches(data, 16, 7, epoch))
        theirs = list(jax_pipeline.train_batches(jdata, 16, 7, epoch))
        on_dev = list(pipeline.device_train_batches(dev, 16, 7, epoch))
        assert [len(b["expression"]) for b in ours] == [16, 16, 8]
        assert len(ours) == len(theirs) == len(on_dev) == pipeline.num_train_steps(40, 16)
        for a, b, c in zip(ours, theirs, on_dev):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(c[k].numpy(), a[k])


def test_three_st_steps_match_jax():
    """The slice end to end: augment ("st", Paeth rotation) -> towers ->
    InfoNCE -> Adam, three steps from shared params."""
    data = pipeline.ConcatSections.from_sections(_sections())
    jcfg = JaxModelConfig(**TINY)
    jtrain = JaxTrainConfig(batch_size=8, lr=LR, seed=0)
    sample = data.take(np.arange(1))
    jmodel, jstate = jax_create_train_state(jcfg, jtrain, {
        "image": sample["image_u8"].astype(np.float32) / 255.0,
        "expression": sample["expression"], "position": sample["position"]})
    cfg = ModelConfig(**TINY)
    model = MclSTExp(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params),
                                          jax.device_get(jstate.batch_stats), cfg), strict=True)
    state = TrainState(model, torch_adam(model.parameters(), LR, jtrain.weight_decay))
    jstep = jax_make_train_step(jmodel, augment_mode="st", donate=False, rot_impl="paeth")
    step = make_train_step("st", rot_impl="paeth")

    for i in range(3):
        batch = data.take(np.arange(8 * i, 8 * i + 8))
        rng = jax.random.PRNGKey(100 + i)
        jstate, jloss = jstep(jstate, batch, rng)
        draws = _jax_st_draws(jax.random.split(rng)[0], 8)
        assert _shears_agree(draws.angles.numpy())
        loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg=f"step {i}")
    assert state.step == 3

    want = params_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
                           cfg)
    got = model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * LR,
                                       err_msg=k)


def test_none_mode_step_matches_jax():
    """augment_mode="none": the plain /255 path, one step."""
    data = pipeline.ConcatSections.from_sections(_sections())
    jtrain = JaxTrainConfig(batch_size=8, lr=LR, seed=1)
    sample = data.take(np.arange(1))
    jmodel, jstate = jax_create_train_state(JaxModelConfig(**TINY), jtrain, {
        "image": sample["image_u8"].astype(np.float32) / 255.0,
        "expression": sample["expression"], "position": sample["position"]})
    cfg = ModelConfig(**TINY)
    model = MclSTExp(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params),
                                          jax.device_get(jstate.batch_stats), cfg), strict=True)
    state = TrainState(model, torch_adam(model.parameters(), LR, jtrain.weight_decay))
    batch = data.take(np.arange(8))
    _, jloss = jax_make_train_step(jmodel, augment_mode="none", donate=False)(
        jstate, batch, jax.random.PRNGKey(0))
    loss = make_train_step("none")(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_train_fold_cpu_writes_checkpoint(tmp_path):
    """train_fold on the CPU (the tests' device): finite losses every step,
    remainder batch included, and a strict-loadable final checkpoint."""
    cfg = Config(
        model=ModelConfig(**TINY),
        train=TrainConfig(batch_size=16, max_epochs=2, log_every=1,
                          checkpoint_every_epochs=1, checkpoint_dir=str(tmp_path)),
        data=DataConfig(dataset="synthetic", patch_size=16),
    )
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(echo=False)
    state = train_fold(cfg, _sections(), fold=0, logger=logger, device="cpu")
    assert state.step == 2 * pipeline.num_train_steps(40, 16)
    losses = [r["loss"] for r in logger.records if "loss" in r]
    assert len(losses) == state.step and np.isfinite(losses).all()
    path = tmp_path / "synthetic" / "S1" / "best_0" / checkpoint.STATE_FILE
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == state.step
    MclSTExp(cfg.model, device="cpu").load_state_dict(saved["model"], strict=True)


def test_check_positions_in_vocab():
    secs = _sections()
    check_positions_in_vocab(secs, 64)
    with pytest.raises(ValueError, match="pos_vocab"):
        check_positions_in_vocab(secs, 3)
    bad = dataclasses.replace(secs[0], positions=secs[0].positions - 1)
    with pytest.raises(ValueError, match="negative"):
        check_positions_in_vocab([bad], 64)


def test_train_step_rejects_unported_modes():
    with pytest.raises(NotImplementedError, match="tenx"):
        make_train_step("tenx")
