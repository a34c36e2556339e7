"""Port parity of the whole slice: data, batches, the "st" and "tenx" train
steps with either attention backend, and the fold driver (resume, all folds).

Both packages start from the same parameters (the JAX init carried over by
``params_from_jax``) and take three steps on the same batches, the port fed
the augmentation draws the JAX step takes from its key. With
``attn_backend="flash"`` the port trains through its flash autograd
Function (on the CPU, the plain versions of the forward-with-residuals,
dK/dV and dQ kernels) and the JAX model through its XLA path, which is what
it runs off a TPU. Tolerances:
  * losses rtol 1e-4: fp32 on both sides, summation order differs;
  * parameters atol 2 * lr: Adam normalizes each step to about lr, so an
    element whose first gradient is ~0 may take the opposite sign in the two
    frameworks and land at most ~2 * lr apart;
  * BatchNorm running stats rtol 1e-4, with an atol 1e-6 floor: a running
    mean near 0 (seen down to ~6e-4) is a sum of terms two orders larger,
    so its fp32 rounding is absolute, not relative.
A resumed fold equals an uninterrupted one exactly: the same operations on
the same values in one process.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu.config import ModelConfig as JaxModelConfig, TrainConfig as JaxTrainConfig
from mclstexp_tpu.data import pipeline as jax_pipeline, synthetic as jax_synthetic
from mclstexp_tpu.train import checkpoint as jax_checkpoint
from mclstexp_tpu.train.state import create_train_state as jax_create_train_state
from mclstexp_tpu.train.step import make_train_step as jax_make_train_step
from mclstexp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mclstexp_tpu_torch.core import layers
from mclstexp_tpu_torch.data import pipeline, synthetic
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.train import checkpoint, loop
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.train.loop import check_positions_in_vocab, train_all_folds, train_fold
from mclstexp_tpu_torch.train.state import TrainState, torch_adam
from mclstexp_tpu_torch.train.step import make_train_step
from mclstexp_tpu_torch.utils.logging import MetricLogger
from test_torch_port_augment import _jax_st_draws, _jax_tenx_draws, _shears_agree

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


def _shared_start(model_kw, seed):
    """(JAX model, JAX state, port state) from the same parameters."""
    data = pipeline.ConcatSections.from_sections(_sections())
    jtrain = JaxTrainConfig(batch_size=8, lr=LR, seed=seed)
    sample = data.take(np.arange(1))
    jmodel, jstate = jax_create_train_state(JaxModelConfig(**model_kw), jtrain, {
        "image": sample["image_u8"].astype(np.float32) / 255.0,
        "expression": sample["expression"], "position": sample["position"]})
    cfg = ModelConfig(**model_kw)
    model = MclSTExp(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params),
                                          jax.device_get(jstate.batch_stats), cfg), strict=True)
    return data, jmodel, jstate, TrainState(model, torch_adam(model.parameters(), LR,
                                                              jtrain.weight_decay))


def _assert_params_match(jstate, model):
    want = params_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
                           model.config)
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


@pytest.mark.parametrize("attn_backend", ["xla", "flash"])
def test_three_st_steps_match_jax(attn_backend, monkeypatch):
    """The slice end to end: augment ("st", Paeth rotation) -> towers ->
    InfoNCE -> Adam, three steps from shared params; with "flash" the spot
    tower's gradients come from the flash backward (dK/dV, dQ)."""
    data, jmodel, jstate, state = _shared_start({**TINY, "attn_backend": attn_backend}, 0)
    jstep = jax_make_train_step(jmodel, augment_mode="st", donate=False, rot_impl="paeth")
    step = make_train_step("st", rot_impl="paeth")
    functions = []  # the autograd node of each flash call: its backward ran through it

    def record(*args):
        out = flash_attention(*args)
        functions.append(type(out.grad_fn).__name__)
        return out

    flash_attention = layers.flash_attention
    monkeypatch.setattr(layers, "flash_attention", record)

    for i in range(3):
        batch = data.take(np.arange(8 * i, 8 * i + 8))
        rng = jax.random.PRNGKey(100 + i)
        jstate, jloss = jstep(jstate, batch, rng)
        draws = _jax_st_draws(jax.random.split(rng)[0], 8)
        assert _shears_agree(draws.angles.numpy())
        loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg=f"step {i}")
    assert state.step == 3
    _assert_params_match(jstate, state.model)
    flash_calls = 3 * len(state.model.spot_encoder) if attn_backend == "flash" else 0
    assert functions == ["FlashAttentionBackward"] * flash_calls


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
    with pytest.raises(NotImplementedError, match="augment_mode 'bogus'"):
        make_train_step("bogus")


@pytest.mark.parametrize("raw_scale", [False, True])
def test_tenx_step_matches_jax(raw_scale):
    """One "tenx" step (the Visium augmentation, raw 0-255 scale or [0, 1])
    against the JAX step, fed the draws the JAX step takes from its key."""
    data, jmodel, jstate, state = _shared_start(TINY, 2)
    batch = data.take(np.arange(8))
    rng = jax.random.PRNGKey(7)
    jstate, jloss = jax_make_train_step(jmodel, augment_mode="tenx", donate=False,
                                        tenx_raw_scale=raw_scale)(jstate, batch, rng)
    draws = _jax_tenx_draws(jax.random.split(rng)[0], 8)
    loss = make_train_step("tenx", tenx_raw_scale=raw_scale)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    _assert_params_match(jstate, state.model)


def _fold_cfg(tmp_path, max_epochs, **data_kw):
    return Config(
        model=ModelConfig(**TINY),
        train=TrainConfig(batch_size=16, max_epochs=max_epochs, log_every=1,
                          checkpoint_every_epochs=0, checkpoint_dir=str(tmp_path), lr=LR),
        data=DataConfig(**{"dataset": "synthetic", "patch_size": 16, **data_kw}),
    )


def test_resume_equals_an_uninterrupted_fold(tmp_path):
    """1 epoch, then resume=True to 2 epochs: the same losses and the same
    state, bit for bit, as 2 epochs in one go (the draws are keyed by
    (seed, fold, epoch, step), the Adam state comes back with the model)."""
    whole = MetricLogger(echo=False)
    want = train_fold(_fold_cfg(tmp_path / "whole", 2), _sections(), 1, whole, device="cpu")
    first, resumed = MetricLogger(echo=False), MetricLogger(echo=False)
    train_fold(_fold_cfg(tmp_path / "split", 1), _sections(), 1, first, device="cpu")
    got = train_fold(_fold_cfg(tmp_path / "split", 2), _sections(), 1, resumed,
                     device="cpu", resume=True)
    steps = pipeline.num_train_steps(40, 16)
    assert [(r["fold"], r["epoch"]) for r in resumed.records
            if r.get("event") == "resume"] == [(1, 1)]
    assert got.step == want.step == 2 * steps

    def losses(logger):
        return [(r["epoch"], r["loss"]) for r in logger.records if "loss" in r]

    assert losses(first) + losses(resumed) == losses(whole)
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(got.model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    for a, b in zip(want.optimizer.state.values(), got.optimizer.state.values()):
        for key in a:
            torch.testing.assert_close(b[key], a[key], rtol=0, atol=0)
    # resume with no checkpoint yet starts from scratch
    fresh = train_fold(_fold_cfg(tmp_path / "none", 1), _sections(), 1, device="cpu",
                       resume=True)
    assert fresh.step == steps


def test_train_all_folds_writes_the_jax_layout(tmp_path):
    """Every fold trained, each checkpoint in the directory the JAX
    package's layout gives it: <root>/<dataset>/<held-out section>/best_<fold>."""
    secs = _sections()
    logger = MetricLogger(echo=False)
    cfg = _fold_cfg(tmp_path, 1)
    got = train_all_folds(cfg, secs, logger=logger, device="cpu")
    want = [jax_checkpoint.fold_checkpoint_dir(str(tmp_path), "synthetic", s.name, f)
            for f, s in enumerate(secs)]
    assert got == want
    for path in got:
        saved = torch.load(os.path.join(path, checkpoint.STATE_FILE), weights_only=True)
        assert saved["step"] == pipeline.num_train_steps(40, 16)
    assert [r["fold"] for r in logger.records if r.get("event") == "final_checkpoint"] == [0, 1, 2]
    assert train_all_folds(cfg, secs, folds=[2], device="cpu") == want[2:]


def test_visium_fold_trains_with_tenx(tmp_path, monkeypatch):
    """dataset="visium" trains with the "tenx" augmentation on the scale
    DataConfig.visium_raw_scale picks."""
    seen = []

    def record(patches, draws, raw_scale=False):
        seen.append(raw_scale)
        return tenx(patches, draws, raw_scale)

    tenx = augment.tenx_augment
    monkeypatch.setattr(augment, "tenx_augment", record)
    for raw in (True, False):
        seen.clear()
        state = train_fold(_fold_cfg(tmp_path / str(raw), 1, dataset="visium",
                                     visium_raw_scale=raw), _sections(), 0, device="cpu")
        assert seen == [raw] * state.step and state.step == pipeline.num_train_steps(40, 16)
        assert (tmp_path / str(raw) / "visium" / "S1" / "best_0" / checkpoint.STATE_FILE).exists()


def test_streamed_fold_is_bit_equal_to_the_resident_fold(tmp_path, monkeypatch):
    """A training set past ``device_data_budget_bytes`` (0 here) streams
    through ``prefetch_to_device``, and the fold takes the same batches in
    the same order: the same losses and state, bit for bit."""
    resident = MetricLogger(echo=False)
    want = train_fold(_fold_cfg(tmp_path / "resident", 2), _sections(), 1, resident, device="cpu")
    streamed = []
    prefetch = loop.prefetch_to_device

    def counting(*args, **kw):
        streamed.append(1)
        return prefetch(*args, **kw)

    monkeypatch.setattr(loop, "prefetch_to_device", counting)
    cfg = _fold_cfg(tmp_path / "streamed", 2)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, device_data_budget_bytes=0))
    log = MetricLogger(echo=False)
    got = train_fold(cfg, _sections(), 1, log, device="cpu")
    assert len(streamed) == 2  # one stream per epoch
    assert [(r["epoch"], r["step"], r["loss"]) for r in log.records if "loss" in r] == \
        [(r["epoch"], r["step"], r["loss"]) for r in resident.records if "loss" in r]
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(got.model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    # within the budget: resident, no stream
    streamed.clear()
    train_fold(_fold_cfg(tmp_path / "again", 1), _sections(), 1, device="cpu")
    assert streamed == []


def test_prefetch_to_device_propagates_producer_errors():
    """A producer-thread exception is raised in the consumer, not taken for
    the end of the epoch (as ``tests/test_data.py`` holds JAX's); a clean
    iterator ends normally; closing the stream early stops its thread."""
    def batches():
        yield {"x": np.zeros((2, 3), np.float32)}
        raise RuntimeError("producer blew up")

    it = pipeline.prefetch_to_device(batches(), "cpu")
    first = next(it)
    assert first["x"].shape == (2, 3) and isinstance(first["x"], torch.Tensor)
    with pytest.raises(RuntimeError, match="producer blew up"):
        next(it)
    assert len(list(pipeline.prefetch_to_device(iter([{"x": np.ones(1)}]), "cpu"))) == 1

    import threading

    endless = pipeline.prefetch_to_device(({"x": np.ones(1)} for _ in iter(int, 1)), "cpu")
    next(endless)
    endless.close()
    assert not any(t.name == "prefetch_to_device" for t in threading.enumerate())
