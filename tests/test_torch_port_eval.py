"""The eval slice: normalization, eval batches, the embedding sweep, metrics
and the LOO evaluation of the port against the JAX package, on the CPU.

Both packages get the same weights (``params_from_jax``) and the same
synthetic sections (made from one seed by each package's own generator,
checked equal). Three sections of 50 spots at B=32 give batches that cross
section boundaries and a remainder of 22. Tolerances, each stated where it
is used: embeddings atol 1e-4 (fp32 towers, sums in another order);
host metrics rtol 1e-6; device metrics rtol 3e-5, the JAX package's own
pin (``tests/test_device_metrics.py``); LOO averages rtol 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.data import normalize as jax_normalize
from mclstexp_tpu.data import pipeline as jax_pipeline
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.infer import embed as jax_embed
from mclstexp_tpu.infer import evaluate as jax_evaluate
from mclstexp_tpu.infer import metrics as jax_metrics
from mclstexp_tpu.models.mclstexp import MclSTExp as JaxMclSTExp
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.data import normalize, pipeline, synthetic
from mclstexp_tpu_torch.infer import embed, evaluate, metrics
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.train import checkpoint
from mclstexp_tpu_torch.train.state import TrainState, torch_adam
from test_torch_port_augment import _jax_tenx_draws

torch.set_num_threads(1)

EMB_TOL = dict(rtol=0, atol=1e-4)
TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, head_layers=2, pos_vocab=64, dense_block_impl="concat",
            attn_backend="flash")
BATCH, TOP_K = 32, 8


@pytest.fixture(scope="module")
def slice_setup():
    jax_sections = jax_synthetic.make_dataset(num_sections=3, num_spots=50, num_genes=24,
                                              patch_size=16, seed=7)
    sections = synthetic.make_dataset(num_sections=3, num_spots=50, num_genes=24,
                                      patch_size=16, seed=7)
    for js, s in zip(jax_sections, sections):
        for field in ("expression", "positions", "centers", "patches", "counts"):
            np.testing.assert_array_equal(getattr(s, field), getattr(js, field))
    jm = JaxMclSTExp(jax_config.ModelConfig(**TINY))
    sample = {"image": jax_sections[0].patches[:2].astype(np.float32) / 255.0,
              "expression": jax_sections[0].expression[:2],
              "position": jax_sections[0].positions[:2]}
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), sample, train=False))
    cfg = config.ModelConfig(**TINY)
    tm = MclSTExp(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"], cfg),
                       strict=True)
    jimg, jspot = jax_embed.compute_embeddings(jm, variables["params"],
                                               variables["batch_stats"], jax_sections, BATCH)
    return dict(jax_sections=jax_sections, sections=sections, jm=jm, variables=variables,
                tm=tm, jimg=jimg, jspot=jspot)


def test_pergene_normalization_matches_jax(slice_setup):
    for s, js in zip(slice_setup["sections"], slice_setup["jax_sections"]):
        np.testing.assert_array_equal(normalize.pergene_logcpm(s.counts),
                                      jax_normalize.pergene_logcpm(js.counts))
        np.testing.assert_array_equal(s.eval_expression, js.eval_expression)
        assert s.eval_expression is s.eval_expression  # computed once
    no_counts = dataclasses.replace(slice_setup["sections"][0], counts=None)
    assert no_counts.eval_expression is no_counts.expression


def test_eval_batches_match_jax(slice_setup):
    data = pipeline.ConcatSections.from_sections(slice_setup["sections"])
    jdata = jax_pipeline.ConcatSections.from_sections(slice_setup["jax_sections"])
    got = list(pipeline.eval_batches(data, BATCH))
    want = list(jax_pipeline.eval_batches(jdata, BATCH))
    assert [len(b["expression"]) for b in got] == [32, 32, 32, 32, 22]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("tower", ["both", "image", "spot"])
def test_compute_embeddings_matches_jax(slice_setup, tower):
    """B=32 spot batches across section boundaries and the remainder; the
    image tower at batch 64 (two batches and a remainder) gives the same
    embeddings as at any other batch."""
    img, spot = embed.compute_embeddings(slice_setup["tm"], slice_setup["sections"], BATCH,
                                         image_batch_size=64, tower=tower, device="cpu")
    assert (img is None) == (tower == "spot") and (spot is None) == (tower == "image")
    if img is not None:
        assert img.shape == (150, 32)
        np.testing.assert_allclose(img, slice_setup["jimg"], **EMB_TOL)
    if spot is not None:
        assert spot.shape == (150, 32)
        np.testing.assert_allclose(spot, slice_setup["jspot"], **EMB_TOL)
    assert slice_setup["tm"].training  # the sweep restores the model's mode


def test_compute_embeddings_as_device_and_prepared(slice_setup):
    sections = slice_setup["sections"]
    prepared = embed.prepare_eval_arrays(sections, device="cpu")
    assert prepared["n"] == 150 and prepared["patches"].shape == (150, 16, 16, 3)
    np.testing.assert_array_equal(prepared["eval_expression"].numpy(),
                                  np.concatenate([s.eval_expression for s in sections]))
    img, spot = embed.compute_embeddings(slice_setup["tm"], sections, BATCH, prepared=prepared,
                                         as_device=True, device="cpu")
    assert isinstance(img, torch.Tensor) and isinstance(spot, torch.Tensor)
    np.testing.assert_allclose(spot.numpy(), slice_setup["jspot"], **EMB_TOL)

    spot_only = embed.prepare_eval_arrays(
        [dataclasses.replace(s, patches=None, counts=None) for s in sections],
        with_patches=False, device="cpu")
    assert spot_only["patches"] is None
    assert spot_only["eval_expression"] is spot_only["expression"]  # no counts: aliased
    jprep = jax_embed.prepare_eval_arrays(slice_setup["jax_sections"], with_patches=False)
    np.testing.assert_array_equal(spot_only["positions"].numpy(), np.asarray(jprep["positions"]))


def test_compute_embeddings_rejects_what_it_does_not_run(slice_setup, monkeypatch):
    """eval_augment=True (the Visium inference-time "tenx" flips and
    rotations per image batch, on the raw 0-255 scale and on [0, 1])
    equals the JAX sweep when both take the same draws: the port's sampler
    is replaced by the JAX sweep's, image batch i keyed by
    fold_in(PRNGKey(seed), i). An unknown tower still raises."""
    jv = slice_setup["variables"]
    batches = []

    def jax_draws(seed, batch_index, batch, device):
        batches.append((batch_index, batch))
        return _jax_tenx_draws(jax.random.fold_in(jax.random.PRNGKey(seed), batch_index), batch)

    monkeypatch.setattr(embed, "sample_eval_draws", jax_draws)
    for raw_scale in (False, True):
        jimg, jspot = jax_embed.compute_embeddings(
            slice_setup["jm"], jv["params"], jv["batch_stats"], slice_setup["jax_sections"],
            BATCH, eval_augment=True, seed=3, raw_scale=raw_scale, image_batch_size=64)
        batches.clear()
        img, spot = embed.compute_embeddings(slice_setup["tm"], slice_setup["sections"], BATCH,
                                             eval_augment=True, seed=3, raw_scale=raw_scale,
                                             image_batch_size=64, device="cpu")
        assert batches == [(0, 64), (1, 64), (2, 22)]
        np.testing.assert_allclose(img, jimg, err_msg=f"raw_scale={raw_scale}", **EMB_TOL)
        np.testing.assert_allclose(spot, jspot, err_msg=f"raw_scale={raw_scale}", **EMB_TOL)
        plain, _ = embed.compute_embeddings(slice_setup["tm"], slice_setup["sections"], BATCH,
                                            raw_scale=raw_scale, image_batch_size=64,
                                            tower="image", device="cpu")
        assert not np.allclose(img, plain, **EMB_TOL)  # the flips and rotations took effect
    with pytest.raises(ValueError, match="tower"):
        embed.compute_embeddings(slice_setup["tm"], slice_setup["sections"], tower="text",
                                 device="cpu")


def test_eval_augment_draws_are_keyed_by_seed_and_batch():
    """The port's own eval draws: one generator per (seed, image batch), so
    a sweep repeats itself for a seed and batch i's draws do not depend on
    the batches before it."""
    a = embed.sample_eval_draws(3, 1, 64, "cpu")
    embed.sample_eval_draws(3, 0, 64, "cpu")
    b = embed.sample_eval_draws(3, 1, 64, "cpu")
    c = embed.sample_eval_draws(4, 1, 64, "cpu")
    for field in ("hflip", "vflip", "rot"):
        assert torch.equal(getattr(a, field), getattr(b, field))
    assert not torch.equal(a.rot, c.rot)


def test_dump_embeddings_reference_layout(slice_setup, tmp_path):
    """Per-section transposed (P, N_i) files, the layout the JAX package
    writes for the same embeddings."""
    sections = slice_setup["sections"]
    sizes = [s.num_spots for s in sections]
    embed.dump_embeddings(slice_setup["tm"], sections, str(tmp_path / "port"), BATCH,
                          device="cpu")
    jax_embed.save_embedding_files(slice_setup["jimg"], slice_setup["jspot"], sizes,
                                   str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.shape == want.shape and got.shape[0] == 32
        np.testing.assert_allclose(got, want, **EMB_TOL)
    with pytest.raises(ValueError, match="section sizes"):
        embed.split_by_section(np.zeros((10, 2)), [4, 5])


@pytest.mark.parametrize("constant_genes", [False, True])
def test_metrics_match_jax(constant_genes):
    """Host bundle rtol 1e-6 (both fp64); device bundle rtol 3e-5 against
    the JAX host bundle, NaN policies included (a constant ground-truth
    gene is dropped from the HVG mean and propagates into the HEG mean
    when it is a HEG). The JAX device bundle is a second reference only
    without constant genes: its fp32 mean of a constant column need not be
    exact, so it can score such a gene where the host drops it."""
    r = np.random.default_rng(constant_genes)
    pred = r.normal(size=(60, 70)).astype(np.float32)
    true = r.normal(loc=1.0, size=(60, 70)).astype(np.float32)
    if constant_genes:
        true[:, 3] = 1.25
        true[:, 40] = 9.0  # the highest mean: a HEG, so heg_pcc is NaN
    want = jax_metrics.expression_metrics(pred, true)
    got = metrics.expression_metrics(pred, true)
    np.testing.assert_array_equal(metrics.heg_indices(true), jax_metrics.heg_indices(true))
    r_got, p_got = metrics.pearson_per_gene(pred, true)
    r_want, p_want = jax_metrics.pearson_per_gene(pred, true)
    np.testing.assert_allclose(r_got, r_want, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(p_got, p_want, rtol=1e-6, equal_nan=True)
    dev = metrics.expression_metrics_device(torch.from_numpy(pred), torch.from_numpy(true),
                                            metrics.heg_indices(true))
    jdev = jax_metrics.expression_metrics_device(jnp.asarray(pred), jnp.asarray(true),
                                                 jax_metrics.heg_indices(true))
    assert set(got) == set(want) == set(dev)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, equal_nan=True, err_msg=k)
        np.testing.assert_allclose(dev[k], want[k], rtol=3e-5, atol=1e-5, equal_nan=True,
                                   err_msg=k)
        if not constant_genes:
            np.testing.assert_allclose(dev[k], jdev[k], rtol=3e-5, atol=1e-5, err_msg=k)
    assert np.isnan(got["heg_pcc"]) == constant_genes


def _jax_loo(slice_setup, device_metrics):
    sections = slice_setup["jax_sections"]
    bounds = jax_evaluate.section_bounds([s.num_spots for s in sections])
    expr_full = np.concatenate([s.eval_expression for s in sections])
    return [jax_evaluate.evaluate_fold_resident(
        f, slice_setup["jimg"], slice_setup["jspot"], jnp.asarray(expr_full), bounds,
        sections[f].eval_expression, TOP_K, 1, device_metrics=device_metrics)
        for f in range(len(sections))]


@pytest.mark.parametrize("device_metrics", [False, True])
def test_loo_eval_matches_jax(slice_setup, device_metrics, tmp_path):
    """The whole slice: compute_embeddings -> evaluate_fold_resident over
    every fold gives the JAX package's four averages (rtol 1e-4), and the
    resident form equals the re-concatenating evaluate_fold."""
    sections = slice_setup["sections"]
    prepared = embed.prepare_eval_arrays(sections, device="cpu")
    img, spot = embed.compute_embeddings(slice_setup["tm"], sections, BATCH, prepared=prepared,
                                         as_device=True, device="cpu")
    bounds = evaluate.section_bounds([s.num_spots for s in sections])
    assert bounds == [(0, 50), (50, 100), (100, 150)]
    per_fold = []
    for f in range(len(sections)):
        pred_path = str(tmp_path / f"S{f}" / "pred.npy")
        per_fold.append(evaluate.evaluate_fold_resident(
            f, img, spot, prepared["eval_expression"], bounds, sections[f].eval_expression,
            TOP_K, 1, prediction_path=pred_path, device_metrics=device_metrics, device="cpu"))
        assert np.load(pred_path).shape == (24, 50)  # genes x spots
        if not device_metrics:
            spots = embed.split_by_section(spot.numpy(), [50, 50, 50])
            folded = evaluate.evaluate_fold(f, img.numpy()[bounds[f][0]:bounds[f][1]], spots,
                                            [s.eval_expression for s in sections], TOP_K, 1,
                                            device="cpu")
            for k, v in folded.items():
                np.testing.assert_allclose(v, per_fold[-1][k], rtol=1e-6, err_msg=k)
    want = _jax_loo(slice_setup, device_metrics)
    for k in want[0]:
        avg = np.mean([m[k] for m in per_fold])
        assert np.isfinite(avg)
        np.testing.assert_allclose(avg, np.mean([m[k] for m in want]), rtol=1e-4, err_msg=k)


def test_evaluate_from_jax_dumps(slice_setup, tmp_path):
    """Phase B over per-fold dumps that the JAX package wrote: the same
    per-fold metrics (rtol 1e-5: identical embeddings, identical
    selection), and the predictions in the reference's file layout."""
    sections = slice_setup["jax_sections"]
    sizes = [s.num_spots for s in sections]
    for f in range(len(sections)):
        jax_embed.save_embedding_files(slice_setup["jimg"], slice_setup["jspot"], sizes,
                                       str(tmp_path / f"embeddings_{f}"))
    exprs = [s.eval_expression for s in sections]
    names = [s.name for s in sections]
    got = evaluate.evaluate_from_embedding_dumps(str(tmp_path), exprs, TOP_K, 1,
                                                 prediction_dir=str(tmp_path / "pred"),
                                                 section_names=names, device="cpu")
    want = jax_evaluate.evaluate_from_embedding_dumps(str(tmp_path), exprs, TOP_K, 1)
    assert got["folds"] == want["folds"] == [0, 1, 2]
    for g, w in zip(got["per_fold"], want["per_fold"]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    pred = np.load(tmp_path / "pred" / names[1] / "matched_spot_expression_pred.npy")
    assert pred.shape == (24, 50)
    with pytest.raises(ValueError, match="spot-count mismatch"):
        evaluate.evaluate_from_embedding_dumps(str(tmp_path), [e[:-1] for e in exprs], TOP_K,
                                               device="cpu")


def test_load_checkpoint_restores_the_model(slice_setup, tmp_path):
    tm = slice_setup["tm"]
    state = TrainState(tm, torch_adam(tm.parameters(), 1e-4, 1e-3), step=7)
    checkpoint.save_checkpoint(str(tmp_path / "best_0"), state)
    fresh = MclSTExp(tm.config, device="cpu")
    assert checkpoint.load_checkpoint(str(tmp_path / "best_0"), fresh) == 7
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    wrong = MclSTExp(dataclasses.replace(tm.config, spot_dim=16), device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        checkpoint.load_checkpoint(str(tmp_path / "best_0"), wrong)
