"""HisToGene's super-resolution grid in the port against the JAX package.

``sr_grid`` and ``sr_section`` are integer bookkeeping and a patch cut, so
they are held exactly: the grid's centers and positions (a random box, a
degenerate one whose 30-bin width rounds to 0, one narrower than a 56-px
step, an empty one), the section's name, zero expression and positions, and
its patches bit for bit (the port cuts them with ``cut_patches``, JAX with
``extract_patches_np``). ``sr_predict`` of HisToGene, Hist2ST and THItoGene,
the weights carried from the JAX variables by
``interop.baseline_params_from_jax``, at the small widths of
``test_torch_port_baselines.py`` and ``test_torch_port_hist2st.py``: the
centers exact, the predictions within those files' ``FWD_TOL`` (atol 1e-4).
"""

import numpy as np
import pytest
import torch
import test_torch_port_baselines as tb
import test_torch_port_hist2st as th

from mclstexp_tpu.baselines import super_resolution as jax_sr
from mclstexp_tpu.baselines import trainer as jax_trainer
from mclstexp_tpu.train.state import TrainState as JaxTrainState
from mclstexp_tpu_torch.baselines import super_resolution as sr
from mclstexp_tpu_torch.baselines import trainer
from mclstexp_tpu_torch.data.section import Section

torch.set_num_threads(1)


def _centers(rng, n, lo, hi):
    return np.stack([rng.integers(lo[0], hi[0], n), rng.integers(lo[1], hi[1], n)],
                    axis=1).astype(np.int32)


@pytest.mark.parametrize("case", ["random", "degenerate", "narrow", "empty"])
def test_sr_grid_is_the_jax_grid(case):
    rng = np.random.default_rng(1)
    centers = {
        "random": _centers(rng, 40, (130, 90), (1900, 1500)),
        # 29 px across: (max - min) // 30 == 0, so r = 1 on both axes
        "degenerate": _centers(rng, 12, (400, 700), (430, 730)),
        # x spans less than one 56-px step: one grid column
        "narrow": np.array([[500, 100], [540, 900], [520, 400]], np.int32),
        # a single spot: no grid at all
        "empty": np.array([[77, 88]], np.int32),
    }[case]
    got, want = sr.sr_grid(centers), jax_sr.sr_grid(centers)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        assert np.array_equal(g, w)
    if case == "narrow":
        assert len(np.unique(got[0][:, 0])) == 1 and len(got[0]) > 1
    if case == "degenerate":
        assert np.array_equal(got[1], got[0])  # r = 1: positions are the centers
    if case == "empty":
        assert got[0].shape == (0, 2)
    for g, w in zip(sr.sr_grid(centers, step=20, n_bins=7),
                    jax_sr.sr_grid(centers, step=20, n_bins=7)):
        assert np.array_equal(g, w)


def _slide_and_section(seed=0):
    """A random uint8 slide and a section of 9 spots whose centers lie on it,
    two at its corners, so grid patches reach past the border."""
    rng = np.random.default_rng(seed)
    slide = rng.integers(0, 256, size=(460, 520, 3), dtype=np.uint8)
    centers = _centers(rng, 9, (4, 10), (500, 440))
    centers[0], centers[1] = (4, 10), (499, 439)
    return slide, Section(name="B1", expression=rng.normal(size=(9, tb.G)).astype(np.float32),
                          positions=centers // 16, centers=centers)


@pytest.mark.parametrize("patch", [16, 17, 112])
def test_sr_section_is_the_jax_section(patch):
    slide, section = _slide_and_section()
    got = sr.sr_section(section, slide, patch, device="cpu")
    want = jax_sr.sr_section(section, slide, patch)
    assert got.name == want.name == f"{section.name}_sr"
    assert got.num_spots == want.num_spots > 50
    for field in ("expression", "positions", "centers", "patches"):
        g, w = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert np.array_equal(g, w), field
    assert not got.expression.any() and got.positions.min() >= 0 and got.positions.max() <= 63
    assert got.patches.shape[1:] == (patch, patch, 3) and got.counts is None


def _jax_state(variables):
    return JaxTrainState(step=0, params=variables["params"],
                         batch_stats=variables.get("batch_stats", {}), opt_state=None, tx=None)


def _family_case(family):
    """(JAX model, port model holding the same weights, JAX variables, config
    kwargs)."""
    if family == "hist2st":
        jmodel, tmodel = th._models(coef_head=True)
        jsecs, _ = th._sections([16])
        variables = th._variables(jmodel, th._padded(jsecs[0]))
        return jmodel, th._carried(tmodel, variables), variables, th._cfg()
    jmodel, tmodel, patch = tb._small(family)
    jsecs, _ = tb._sections([16], patch)
    variables = tb._jax_variables(jmodel, tb._padded_batch(jsecs[0], family, patch), family)
    return jmodel, tb._carried(tmodel, variables), variables, tb._cfg(family, patch)


@pytest.mark.parametrize("family", ["histogene", "hist2st", "thitogene"])
def test_sr_predict_matches_jax(family):
    jmodel, tmodel, variables, cfg_kw = _family_case(family)
    slide, section = _slide_and_section()
    jcfg, tcfg = jax_trainer.BaselineConfig(**cfg_kw), trainer.BaselineConfig(**cfg_kw)
    want, want_centers = jax_sr.sr_predict(jmodel, _jax_state(variables), section, slide, jcfg)
    got, got_centers = sr.sr_predict(tmodel, section, slide, tcfg)
    assert np.array_equal(got_centers, want_centers)
    assert got.shape == (len(want_centers), tb.G) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), **tb.FWD_TOL)
