"""The port's ``baseline`` subcommand against the JAX CLI's, on the CPU.

* Config parity: the ``BaselineConfig`` each CLI builds from the same argv
  (each family; flags unset and set; ``--bake``, ``--zinb``, ``--lamb``,
  ``--dtype bfloat16``; THItoGene on cSCC), captured at the trainer's entry
  so that nothing trains.
* Scoring parity: on a small HER2ST tree (``synthetic.write_st_layout``),
  both CLIs score one reference checkpoint with ``--torch-checkpoint``: the
  JSON metrics within rtol 1e-4 / atol 1e-5; HisToGene (``--n-layers 1``)
  with ``--super-resolution``, whose npz centers are equal and predictions
  within atol 1e-4 (``FWD_TOL`` of the slide parity tests); BLEEP with
  resnet50, the smallest tower of the CLI's menu that both importers take,
  in each ``--bleep-retrieval`` mode.
* Round trip: ``baseline`` trains, saves ``best_<fold>``, and
  ``--load-checkpoint`` of it prints the same JSON, for each family.
* ``--super-resolution`` off her2st exits as JAX's does; ``--dp`` is not a
  flag of the port (argparse's exit code 2).

Every command runs in a working directory of its own, on ``--device cpu``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from test_torch_port_baseline_import import _timm_name

from mclstexp_tpu.baselines import trainer as jax_trainer
from mclstexp_tpu.cli import main as jax_cli
from mclstexp_tpu_torch.baselines import models, trainer
from mclstexp_tpu_torch.cli import main as cli
from mclstexp_tpu_torch.data import synthetic

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


class _Captured(Exception):
    pass


def _captured_config(module, trainer_module, argv, monkeypatch):
    """The BaselineConfig ``module``'s ``baseline`` hands its trainer."""
    seen = {}

    def capture(cfg, *args, **kw):
        seen["cfg"] = cfg
        raise _Captured

    for name in ("train_baseline_fold", "train_bleep_fold"):
        monkeypatch.setattr(trainer_module, name, capture)
    monkeypatch.setattr(module, "_load_sections",
                        lambda cfg, **kw: synthetic.make_dataset(num_genes=20, patch_size=8))
    with pytest.raises(_Captured):
        module.main(argv)
    return seen["cfg"]


SET = ["--lr", "3e-4", "--weight_decay", "0.01", "--dropout", "0.3", "--temperature", "0.5",
       "--max_epochs", "7", "--batch_size", "64", "--seed", "3"]


@pytest.mark.parametrize("extra", [
    [], SET, ["--patch-size", "112", "--dtype", "bfloat16"],
    ["--bake", "2", "--zinb", "0", "--lamb", "0.1", "--n-layers", "3"],
    ["--dataset", "cscc"], ["--dataset", "cscc", "--n-layers", "2"],
    ["--bleep-encoder", "vit", "--bleep-retrieval", "simple", "--fold", "2"],
], ids=["unset", "set", "patch-bf16", "hist2st-flags", "cscc", "cscc-n-layers", "bleep-flags"])
@pytest.mark.parametrize("family", ["histogene", "hist2st", "thitogene", "bleep"])
def test_baseline_config_matches_jax(family, extra, monkeypatch):
    argv = ["baseline", "--baseline", family, "--dataset", "synthetic"] + extra
    got = _captured_config(cli, trainer, argv + ["--device", "cpu"], monkeypatch)
    want = _captured_config(jax_cli, jax_trainer, argv, monkeypatch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if family == "thitogene" and extra == ["--dataset", "cscc"]:
        assert got.n_layers == 8


def _run(module, argv, capsys):
    """Run one CLI command; returns the JSON block it prints last."""
    assert module.main(argv) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.rindex("\n{") + 1 if "\n{" in out else out.index("{"):])


@pytest.fixture(scope="module")
def her2st_tree(tmp_path_factory):
    """A HER2ST tree of 3 sections and its gene panel; (root, panel path)."""
    work = tmp_path_factory.mktemp("baseline_tree")
    root = str(work / "her2st")
    _, genes = synthetic.write_st_layout(root, num_sections=3, num_spots=[40, 55, 31],
                                         num_genes=24, seed=5)
    panel = str(work / "panel.npy")
    np.save(panel, np.array(genes))
    return root, panel


def _reference_checkpoint(path, family, n_genes, **kw):
    """A reference-layout checkpoint of ``family`` at the CLI's widths, its
    weights drawn from a seed (BLEEP's tower in timm's names)."""
    cfg = trainer.BaselineConfig(model=family, n_genes=n_genes, **kw)
    model = models.init_baseline_parameters(trainer.build_baseline(cfg, device="cpu"),
                                            torch.Generator().manual_seed(11))
    torch.save({_timm_name(k) if family == "bleep" else k: v
                for k, v in model.state_dict().items()}, path)
    return path


def _assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], value, **METRIC_TOL, err_msg=key)


def test_histogene_super_resolution_scores_as_jax(her2st_tree, tmp_path, monkeypatch, capsys):
    root, panel = her2st_tree
    monkeypatch.chdir(tmp_path)
    pt = _reference_checkpoint("histogene.pt", "histogene", 24, patch_size=32, n_layers=1)
    argv = ["baseline", "--baseline", "histogene", "--dataset", "her2st", "--data-root", root,
            "--gene-panel", panel, "--patch-size", "32", "--n-layers", "1", "--fold", "1",
            "--torch-checkpoint", pt]
    got = _run(cli, argv + ["--super-resolution", "port_sr.npz", "--device", "cpu"], capsys)
    want = _run(jax_cli, argv + ["--super-resolution", "jax_sr.npz"], capsys)
    got_sr, want_sr = got.pop("super_resolution"), want.pop("super_resolution")
    _assert_metrics_close(got, want)
    assert got_sr == {"path": "port_sr.npz", "grid_spots": want_sr["grid_spots"]}
    port, ref = np.load("port_sr.npz"), np.load("jax_sr.npz")
    assert np.array_equal(port["centers"], ref["centers"])
    assert port["predictions"].shape == (want_sr["grid_spots"], 24) and want_sr["grid_spots"] > 9
    np.testing.assert_allclose(port["predictions"], ref["predictions"], **FWD_TOL)


@pytest.fixture(scope="module")
def bleep_checkpoint(her2st_tree, tmp_path_factory):
    return _reference_checkpoint(str(tmp_path_factory.mktemp("bleep") / "bleep.pt"), "bleep",
                                 24, encoder_name="resnet50")


@pytest.mark.parametrize("mode", ["simple", "average", "weighted"])
def test_bleep_scores_as_jax_in_each_mode(mode, her2st_tree, bleep_checkpoint, tmp_path,
                                          monkeypatch, capsys):
    root, panel = her2st_tree
    monkeypatch.chdir(tmp_path)
    argv = ["baseline", "--baseline", "bleep", "--dataset", "her2st", "--data-root", root,
            "--gene-panel", panel, "--patch-size", "32", "--bleep-retrieval", mode,
            "--torch-checkpoint", bleep_checkpoint]
    got = _run(cli, argv + ["--device", "cpu"], capsys)
    want = _run(jax_cli, argv, capsys)
    assert sorted(got) == sorted(want)
    for key, value in want.items():  # top-1 may predict a HEG constant: NaN on both sides
        if np.isnan(value):
            assert np.isnan(got[key]), key
        else:
            np.testing.assert_allclose(got[key], value, **METRIC_TOL, err_msg=key)


ROUND_TRIP = {
    "histogene": ["--n-layers", "1"],
    "hist2st": ["--bake", "1"],
    "thitogene": ["--n-layers", "1", "--patch-size", "112"],
    "bleep": ["--bleep-encoder", "tiny_cnn"],
}


@pytest.mark.parametrize("family", sorted(ROUND_TRIP))
def test_train_then_load_checkpoint_prints_the_same_json(family, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["baseline", "--baseline", family, "--dataset", "synthetic", "--device", "cpu",
            "--max_epochs", "1"] + ROUND_TRIP[family]
    trained = _run(cli, argv, capsys)
    saved = os.path.join("model_result", "baselines", family, "best_0")
    assert os.path.isfile(os.path.join(saved, "state.pt"))
    assert all(np.isfinite(v) for k, v in trained.items() if k != "heg_pcc")
    assert _run(cli, argv + ["--load-checkpoint", saved], capsys) == trained
    if family == "histogene":
        with pytest.raises(SystemExit) as port_exit:
            cli.main(argv + ["--load-checkpoint", saved, "--super-resolution", "sr.npz"])
        pt = _reference_checkpoint("h.pt", "histogene", 32, patch_size=32, n_layers=1)
        with pytest.raises(SystemExit) as jax_exit:
            jax_cli.main(["baseline", "--baseline", "histogene", "--dataset", "synthetic",
                          "--n-layers", "1", "--torch-checkpoint", pt,
                          "--super-resolution", "sr.npz"])
        assert str(port_exit.value) == str(jax_exit.value) and "her2st" in str(port_exit.value)
        assert not os.path.exists("sr.npz")


def test_dp_is_not_a_flag_of_the_port(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["baseline", "--baseline", "bleep", "--dataset", "synthetic", "--dp",
                  "--device", "cpu"])
    assert e.value.code == 2 and "--dp" in capsys.readouterr().err
