"""The port's CLI end to end on the CPU: hvg -> train -> eval -> predict ->
export-torch -> eval --torch-checkpoint, and the embedding dumps.

The synthetic preset (3 sections of 64 spots) with densenet121 on 32 px
patches: ``tiny_cnn`` has no reference layout to export. One epoch of fold
0. What must hold:
* ``eval --torch-checkpoint`` of the exported ``.pt`` gives the averages of
  ``eval`` of the checkpoint bit for bit (the same weights, the same
  program);
* ``predict``'s metrics and ``eval --from-embeddings`` on ``eval
  --save-embeddings``'s dumps equal ``eval``'s fold (the same selection;
  the held-out rows masked on one side, dropped on the other);
* ``eval --device-metrics`` agrees with the host metrics within rtol 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

from mclstexp_tpu_torch.cli.main import main
from mclstexp_tpu_torch.data import synthetic

torch.set_num_threads(1)

FLAGS = ["--dataset", "synthetic", "--encoder_name", "densenet121", "--patch-size", "32",
         "--device", "cpu"]


def _run(argv, capsys):
    assert main(argv + FLAGS) == 0
    return capsys.readouterr().out


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One trained fold-0 checkpoint in a working directory of its own."""
    work = tmp_path_factory.mktemp("cli_chain")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert main(["train", "--fold", "0", "--max_epochs", "1"] + FLAGS) == 0
    finally:
        os.chdir(cwd)
    return work


def test_train_writes_the_fold_checkpoint_and_its_log(trained):
    name = synthetic.make_dataset(patch_size=32)[0].name
    assert (trained / "model_result" / "synthetic" / name / "best_0" / "state.pt").exists()
    log = [json.loads(line) for line in open(trained / "model_result" / "train_log.jsonl")]
    losses = [r["epoch_loss"] for r in log if "epoch_loss" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_eval_predict_export_and_reimport_agree(trained, monkeypatch, capsys):
    monkeypatch.chdir(trained)
    name = synthetic.make_dataset(patch_size=32)[0].name
    ckpt = os.path.join("model_result", "synthetic", name, "best_0")
    printed = _run(["eval", "--fold", "0", "--json", "eval.json"], capsys)
    base = _json("eval.json")
    assert base["folds"] == [0] and all(np.isfinite(v) for v in base["avg"].values())
    assert f"avg hvg pcc: {base['avg']['hvg_pcc']:.4f}" in printed

    _run(["eval", "--fold", "0", "--device-metrics", "--json", "dev.json"], capsys)
    for k, v in _json("dev.json")["avg"].items():
        np.testing.assert_allclose(v, base["avg"][k], rtol=1e-4, err_msg=k)

    out = _run(["predict", "--fold", "0", "--checkpoint", ckpt, "--out", "pred.npy"], capsys)
    assert json.loads(out) == base["per_fold"][0]
    pred = np.load("pred.npy")
    assert pred.shape == (32, 64) and np.isfinite(pred).all()  # genes x spots

    _run(["export-torch", "--checkpoint", ckpt, "--out", "ref.pt"], capsys)
    exported = torch.load("ref.pt", weights_only=True)
    assert exported["x_embed.weight"].shape == (65536, 32)
    assert "image_encoder.model.0.denseblock4.denselayer16.conv2.weight" in exported
    _run(["eval", "--fold", "0", "--torch-checkpoint", "ref.pt", "--json", "pt.json"], capsys)
    assert _json("pt.json") == base  # bit for bit

    os.rename("ref.pt", f"{name}_0.pt")  # a template names each fold's file
    _run(["eval", "--fold", "0", "--torch-checkpoint", "{name}_{fold}.pt", "--json", "t.json"],
         capsys)
    assert _json("t.json") == base


def test_embedding_dumps_score_as_the_checkpoint(trained, monkeypatch, capsys):
    monkeypatch.chdir(trained)
    _run(["hvg", "--out", "pre"], capsys)
    names = [s.name for s in synthetic.make_dataset(patch_size=32)]
    assert sorted(os.listdir(os.path.join("pre", "synthetic"))) == names
    _run(["eval", "--fold", "0", "--save-embeddings", "--json", "eval.json"], capsys)
    dump = os.path.join("embedding_result", "synthetic_result")
    assert sorted(os.listdir(os.path.join(dump, "embeddings_0"))) == sorted(
        [f"img_embeddings_{i}.npy" for i in (1, 2, 3)]
        + [f"spot_embeddings_{i}.npy" for i in (1, 2, 3)])
    _run(["eval", "--fold", "0", "--from-embeddings", dump, "--preprocessed-root", "pre",
          "--json", "dumps.json"], capsys)
    got, want = _json("dumps.json"), _json("eval.json")
    assert got["folds"] == [0]
    assert got["per_fold"] == want["per_fold"]
