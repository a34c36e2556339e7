"""The port's data layer and command line on the card.

These tests need an NVIDIA card and skip without one:

    python -m pytest --noconftest tests/test_torch_port_card_cli.py -m gpu

The data layer reads a HER2ST tree and a Visium tree with the standard
library, the extract_patches kernel cutting each section once. The command
line runs on one synthetic HER2ST tree (4 sections of 300-700 spots x 2,000
genes), each subcommand a process of its own from the tree's working
directory, as a user starts it: ``hvg``, ``train``, ``eval``, ``predict``,
``export-torch``, ``serve``, ``baseline`` for every family, bf16, and the
multi-process forms under ``torchrun`` (one rank per card). Each child
prints its kernels' launch counts on its last line: row_shift 3 a train
step, extract_patches once per section on a cold patch cache and never on a
cache hit.
"""

import base64
import json
import math
import os
import subprocess
import sys
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from _torch_port_card import (DP_LOSS_RTOL_LONG, DP_STAT_RTOL_LONG, card,  # noqa: F401
                              child_env, reset_counts, shear_launches, state_diff)
from mclstexp_tpu_torch.config import get_config
from mclstexp_tpu_torch.data import genes, st_dataset, synthetic
from mclstexp_tpu_torch.data.pipeline import num_train_steps
from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_np
from mclstexp_tpu_torch.train import checkpoint

pytestmark = pytest.mark.gpu

# A subcommand as a user starts it, ``python -m mclstexp_tpu_torch.cli``, in
# a process of its own; after it, the kernels' launch counts of that process
# on the last line of its standard output.
_CLI_CHILD = """import json, sys
from mclstexp_tpu_torch.cli.main import main
from mclstexp_tpu_torch.ops.patches import extract_patches
from mclstexp_tpu_torch.ops.row_shift import row_shift
rc = main(sys.argv[1:])
print(json.dumps({"row_shift": dict(row_shift.kernel_launches),
                  "extract_patches": extract_patches.launches}), flush=True)
sys.exit(rc)
"""


def _run(tree, argv, ranks: int = 0):
    """One subcommand in a new process from the tree's working directory, or
    under ``torchrun`` with ``ranks`` processes: its standard output before
    the counts (``out``), its standard error (``err``) and the launch counts
    (``counts``; one dict per rank under torchrun)."""
    torch.cuda.empty_cache()  # the child shares the card with this process
    if ranks:
        child = os.path.join(tree.work, "cli_child.py")
        with open(child, "w") as f:
            f.write(_CLI_CHILD)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={ranks}", child]
    else:
        cmd = [sys.executable, "-c", _CLI_CHILD]
    proc = subprocess.run(cmd + argv, capture_output=True, text=True, env=child_env(),
                          cwd=tree.work, timeout=600)
    assert proc.returncode == 0, \
        f"{argv} exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}"
    lines = proc.stdout.rstrip("\n").splitlines()
    counts = [json.loads(line) for line in lines if line.startswith('{"row_shift"')]
    out = "\n".join(line for line in lines if not line.startswith('{"row_shift"'))
    return types.SimpleNamespace(out=out, err=proc.stderr,
                                 counts=counts if ranks else counts[-1])


def _quiet(counts) -> None:
    """No slide read past the patch cache and no train step."""
    assert counts["extract_patches"] == 0 and not any(counts["row_shift"].values()), counts


def _json(tree, name):
    with open(os.path.join(tree.work, name)) as f:
        return json.load(f)


def _printed_json(out: str):
    """The JSON block a ``baseline`` command prints last (``indent=2``)."""
    return json.loads(out[out.rindex("\n{") + 1:] if "\n{" in out else out[out.index("{"):])


@pytest.fixture(scope="module")
def tree(card, tmp_path_factory):
    """The HER2ST tree under a working directory, and the flags that name it
    and its 785-gene panel (made by ``hvg --select-panel``)."""
    work = str(tmp_path_factory.mktemp("cli"))
    root = os.path.join(work, "her2st")
    sizes = [int(n) for n in np.random.default_rng(7).integers(300, 701, size=4)]
    names, _ = synthetic.write_st_layout(root, num_sections=4, num_spots=sizes,
                                         num_genes=2000, seed=1)
    panel = os.path.join(work, "panel", "her2st_hvg_panel.npy")
    data = ["--dataset", "her2st", "--data-root", root]
    return types.SimpleNamespace(work=work, root=root, sizes=sizes, names=names, panel=panel,
                                 data=data, flags=data + ["--gene-panel", panel],
                                 cfg=get_config("her2st"))


@pytest.fixture(scope="module")
def panel(tree):
    _quiet(_run(tree, ["hvg", "--select-panel", "--panel-size", str(tree.cfg.model.spot_dim),
                       "--out", "panel"] + tree.data).counts)
    return genes.load_panel("her2st", tree.panel)


@pytest.fixture(scope="module")
def preprocessed(tree, panel):
    """``hvg --out pre``: each section's preprocessed matrix."""
    _quiet(_run(tree, ["hvg", "--out", "pre"] + tree.flags).counts)
    return os.path.join(tree.work, "pre", "her2st")


@pytest.fixture(scope="module")
def trained(tree, panel):
    """``train`` of fold 0 for one epoch: the first command to read the
    slides. Returns its launch counts and its checkpoint."""
    counts = _run(tree, ["train", "--fold", "0", "--max_epochs", "1"] + tree.flags).counts
    ckpt = checkpoint.fold_checkpoint_dir(os.path.join(tree.work, "model_result"), "her2st",
                                          tree.names[0], 0)
    return counts, ckpt


@pytest.fixture(scope="module")
def evaluated(tree, trained):
    """``eval`` of fold 0 with host metrics: its JSON."""
    _quiet(_run(tree, ["eval", "--fold", "0", "--json", "eval.json"] + tree.flags).counts)
    return _json(tree, "eval.json")


@pytest.fixture(scope="module")
def histogene(tree, panel):
    """``baseline --baseline histogene`` (112 px, one epoch) with
    ``--super-resolution``: the first command to read the slides at 112 px.
    Returns its output, launch counts and printed scores."""
    run = _run(tree, ["baseline", "--baseline", "histogene", "--patch-size", "112",
                      "--max_epochs", "1", "--super-resolution", "sr.npz"] + tree.flags)
    return run.out, run.counts, _printed_json(run.out)


def test_hvg_panel_and_matrices(tree, panel, preprocessed):
    """``hvg --select-panel``: the preset's 785 genes; ``hvg``: each section's
    (genes, spots) matrix, finite; neither reads a slide."""
    m = tree.cfg.model
    assert len(panel) == m.spot_dim
    for name, n in zip(tree.names, tree.sizes):
        mat = np.load(os.path.join(preprocessed, name, "preprocessed_matrix.npy"))
        assert mat.shape == (m.spot_dim, n) and np.isfinite(mat).all(), (name, mat.shape)


def test_train(tree, trained):
    """One launch per section on the cold cache, the shears of every step;
    one finite epoch loss in train_log.jsonl."""
    counts, ckpt = trained
    steps = num_train_steps(sum(tree.sizes[1:]), tree.cfg.train.batch_size)
    assert counts["extract_patches"] == len(tree.names), counts
    assert counts["row_shift"] == shear_launches(steps), counts
    with open(os.path.join(tree.work, "model_result", "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    epoch = [r for r in rows if "epoch_loss" in r]
    assert len(epoch) == 1 and math.isfinite(epoch[0]["epoch_loss"]), rows
    assert os.path.isfile(os.path.join(ckpt, checkpoint.STATE_FILE))


def test_eval_device_metrics_and_predict(tree, trained, evaluated):
    """``eval --device-metrics`` within rtol 1e-4 of the host metrics;
    ``predict`` prints eval's fold 0 and writes (genes, spots)."""
    _, ckpt = trained
    _quiet(_run(tree, ["eval", "--fold", "0", "--device-metrics", "--json", "dev.json"]
                + tree.flags).counts)
    dev = _json(tree, "dev.json")
    for k, v in evaluated["avg"].items():
        assert math.isfinite(v) and math.isclose(v, dev["avg"][k], rel_tol=1e-4), (k, v, dev)
    run = _run(tree, ["predict", "--fold", "0", "--checkpoint", ckpt, "--out", "pred.npy"]
               + tree.flags)
    _quiet(run.counts)
    assert json.loads(run.out) == evaluated["per_fold"][0]
    assert np.load(os.path.join(tree.work, "pred.npy")).shape == (tree.cfg.model.spot_dim,
                                                                  tree.sizes[0])


def test_export_torch_scores_alike(tree, trained, evaluated):
    """``export-torch`` of the checkpoint, then ``eval --torch-checkpoint``:
    the same JSON as ``eval``."""
    _, ckpt = trained
    _quiet(_run(tree, ["export-torch", "--checkpoint", ckpt, "--out", "ref.pt"]
                + tree.flags).counts)
    _quiet(_run(tree, ["eval", "--fold", "0", "--torch-checkpoint", "ref.pt", "--json",
                       "pt.json"] + tree.flags).counts)
    assert _json(tree, "pt.json") == evaluated


def test_eval_from_saved_embeddings(tree, preprocessed, trained):
    """``eval --save-embeddings``, then ``--from-embeddings`` of the dumps
    with ``hvg``'s matrices: the same per-fold scores."""
    _quiet(_run(tree, ["eval", "--fold", "0", "--save-embeddings", "--json", "save.json"]
                + tree.flags).counts)
    _quiet(_run(tree, ["eval", "--fold", "0", "--from-embeddings",
                       os.path.join("embedding_result", "her2st_result"), "--preprocessed-root",
                       "pre", "--json", "dumps.json"] + tree.flags).counts)
    assert _json(tree, "dumps.json")["per_fold"] == _json(tree, "save.json")["per_fold"]


def test_serve_answers_as_the_service(tree, panel, trained):
    """``python -m mclstexp_tpu_torch.cli serve`` on a free port: a POST of 37
    patches answered as an in-process service built from the same checkpoint
    (within 1e-6), the same number of active keys."""
    from mclstexp_tpu_torch.infer.serve import PredictionService
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp

    _, ckpt = trained
    cfg = tree.cfg
    patches = np.ascontiguousarray(st_dataset.load_her2st(
        tree.root, panel, names=tree.names[:1], patch_size=cfg.data.patch_size,
        cache_dir=os.path.join(tree.work, "patch_cache", f"her2st_{cfg.data.patch_size}"),
        device="cuda")[0].patches[:37])
    torch.cuda.empty_cache()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mclstexp_tpu_torch.cli", "serve", "--checkpoint", ckpt,
         "--port", "0", "--exclude-fold", "0"] + tree.flags,
        stdout=subprocess.PIPE, text=True, env=child_env(), cwd=tree.work)
    drain = None
    try:
        banner = None
        for line in proc.stdout:  # ends when the process does
            if line.startswith('{"serving"'):
                banner = json.loads(line)
                break
        assert banner is not None, f"serve exited {proc.wait()} without serving"
        drain = threading.Thread(target=proc.stdout.read)  # to its end
        drain.start()
        body = {"patches_b64": base64.b64encode(patches.tobytes()).decode(),
                "shape": list(patches.shape), "b64": True}
        req = urllib.request.Request(banner["serving"] + "/predict",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            answer = json.loads(r.read())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if drain is not None:
            drain.join()
        proc.stdout.close()
    got = np.frombuffer(base64.b64decode(answer["result_b64"]),
                        np.float32).reshape(answer["shape"])
    model = MclSTExp(cfg.model, device="cuda")
    checkpoint.load_checkpoint(ckpt, model)
    sections = st_dataset.load_her2st(tree.root, panel, with_patches=False, device="cuda")
    service = PredictionService.from_sections(
        model, sections, batch_size=cfg.eval.batch_size, exclude_section=0,
        top_k=cfg.eval.top_k, weight_ord=cfg.eval.weight_ord,
        patch_size=cfg.data.patch_size, device="cuda")
    try:
        want = service.predict(patches)
        info = service.info()
    finally:
        service.close()
    assert got.shape == (37, cfg.model.spot_dim)
    assert float(np.abs(got - want).max()) <= 1e-6
    assert banner["num_active_keys"] == info["num_active_keys"], (banner, info)


def test_bf16_train_and_eval(tree, trained):
    """``train --dtype bfloat16`` saves fold 0's checkpoint; ``eval --dtype
    bfloat16`` of it scores finite (a checkpoint keeps no dtype)."""
    flags = tree.flags + ["--checkpoint-dir", "model_result_bf16"]
    _run(tree, ["train", "--fold", "0", "--max_epochs", "1", "--dtype", "bfloat16"] + flags)
    saved = os.path.join(tree.work, "model_result_bf16", "her2st")
    assert any(os.path.isfile(os.path.join(saved, nm, "best_0", checkpoint.STATE_FILE))
               for nm in sorted(os.listdir(saved))), os.listdir(saved)
    _run(tree, ["eval", "--fold", "0", "--dtype", "bfloat16", "--json", "eval_bf16.json"]
         + flags)
    avg = _json(tree, "eval_bf16.json")["avg"]
    assert all(math.isfinite(v) for v in avg.values()), avg


# --- baseline -----------------------------------------------------------------------------------

def _saved(tree, family):
    return os.path.join(tree.work, "model_result", "baselines", family, "best_0")


def _finite(scores, keys=("hvg_pcc", "heg_pcc", "mse", "mae")):
    assert all(math.isfinite(scores[k]) for k in keys), scores


def test_baseline_histogene_with_super_resolution(tree, panel, histogene):
    """HisToGene trains an epoch and saves ``best_0``; ``--super-resolution``
    writes the held-out section's ``sr_grid`` and finite predictions, its
    cut one more launch; ``--load-checkpoint`` of ``best_0`` trains no step
    and prints the same scores and grid predictions bit for bit."""
    from mclstexp_tpu_torch.baselines.super_resolution import sr_grid

    out, counts, trained = histogene
    _finite(trained)
    assert "epoch=0" in out and os.path.isfile(os.path.join(_saved(tree, "histogene"),
                                                            checkpoint.STATE_FILE)), out
    assert not any(counts["row_shift"].values())
    sections = st_dataset.load_her2st(tree.root, panel, patch_size=112, device="cpu",
                                      cache_dir=os.path.join(tree.work, "patch_cache",
                                                             "her2st_112"))
    grid, _ = sr_grid(sections[0].centers)
    sr = np.load(os.path.join(tree.work, "sr.npz"))
    assert np.array_equal(sr["centers"], grid)
    assert sr["predictions"].shape == (len(grid), len(panel))
    assert np.isfinite(sr["predictions"]).all()
    assert trained["super_resolution"]["grid_spots"] == len(grid)
    assert counts["extract_patches"] == len(tree.names) + 1, counts

    run = _run(tree, ["baseline", "--baseline", "histogene", "--patch-size", "112",
                      "--max_epochs", "1", "--super-resolution", "sr_loaded.npz",
                      "--load-checkpoint", _saved(tree, "histogene")] + tree.flags)
    out, counts = run.out, run.counts
    loaded = _printed_json(out)
    assert {k: v for k, v in loaded.items() if k != "super_resolution"} == \
        {k: v for k, v in trained.items() if k != "super_resolution"}
    assert "loss=" not in out and counts["extract_patches"] == 1, counts
    assert not any(counts["row_shift"].values())
    assert np.array_equal(np.load(os.path.join(tree.work, "sr_loaded.npz"))["predictions"],
                          sr["predictions"])


def test_baseline_histogene_checkpoint_on_the_cpu(tree, panel, histogene):
    """HisToGene's ``best_0`` on the CPU: ``evaluate_baseline_fold`` and the
    grid's predictions within 1e-3 of the card's; the grid cut on the card
    bit-equal to ``extract_patches_np``."""
    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.baselines.super_resolution import sr_grid, sr_predict
    from mclstexp_tpu_torch.data.io import load_slide

    trained = histogene[2]
    cache = os.path.join(tree.work, "patch_cache", "her2st_112")
    sections = st_dataset.load_her2st(tree.root, panel, patch_size=112, device="cpu",
                                      cache_dir=cache)
    cfg = trainer.BaselineConfig(model="histogene", n_genes=len(panel), patch_size=112)
    cpu = trainer.init_baseline(cfg, "cpu")
    checkpoint.apply_checkpoint(cpu, checkpoint.restore_checkpoint(_saved(tree, "histogene")))
    cpu_metrics = trainer.evaluate_baseline_fold(cfg, sections, 0, cpu.model)
    assert max(abs(cpu_metrics[k] - trained[k]) for k in cpu_metrics) <= 1e-3, \
        (cpu_metrics, trained)
    slide = load_slide(st_dataset.her2st_slide_path(tree.root, tree.names[0]))
    cpu_sr, _ = sr_predict(cpu.model, sections[0], slide, cfg)
    sr = np.load(os.path.join(tree.work, "sr.npz"))
    assert float(np.abs(cpu_sr - sr["predictions"]).max()) <= 1e-3

    grid, _ = sr_grid(sections[0].centers)
    cut = extract_patches(torch.from_numpy(slide).cuda(),
                          torch.from_numpy(grid.astype(np.int64)).cuda(), cfg.patch_size)
    assert np.array_equal(cut.cpu().numpy(), extract_patches_np(slide, grid, cfg.patch_size))


def test_baseline_hist2st_and_its_lightning_checkpoint(tree, histogene):
    """Hist2ST (zinb 0.25, bake 5) trains an epoch on the 112-px cache; its
    ``state.pt`` rewritten in the reference's Lightning layout and scored by
    ``--torch-checkpoint``: the trained run's scores exactly."""
    hist2st = ["baseline", "--baseline", "hist2st", "--patch-size", "112"]
    run = _run(tree, hist2st + ["--max_epochs", "1"] + tree.flags)
    _quiet(run.counts)
    scores = _printed_json(run.out)
    _finite(scores)
    state = checkpoint.restore_checkpoint(_saved(tree, "hist2st"))
    torch.save({"epoch": 0, "global_step": state["step"],
                "state_dict": {f"model.{k}": v for k, v in state["model"].items()}},
               os.path.join(tree.work, "hist2st_lightning.ckpt"))
    run = _run(tree, hist2st + ["--torch-checkpoint", "hist2st_lightning.ckpt"] + tree.flags)
    _quiet(run.counts)
    assert _printed_json(run.out) == scores


def test_baseline_thitogene(tree, histogene):
    run = _run(tree, ["baseline", "--baseline", "thitogene", "--patch-size", "112",
                      "--max_epochs", "1"] + tree.flags)
    _quiet(run.counts)
    _finite(_printed_json(run.out))


def _bleep_flat_hegs(tree, gene_panel) -> int:
    """How many of the held-out section's 50 highest genes the BLEEP fold
    saved by ``baseline --bleep-retrieval weighted`` predicts constant over
    its queries (its HEG PCC is NaN exactly when one is)."""
    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.infer import embed, metrics
    from mclstexp_tpu_torch.ops import retrieval

    cfg = trainer.BaselineConfig(model="bleep", n_genes=len(gene_panel), patch_size=224)
    model = trainer.build_baseline(cfg, "cuda")
    checkpoint.load_checkpoint(_saved(tree, "bleep"), model)
    sections = st_dataset.load_her2st(tree.root, gene_panel, patch_size=224,
                                      cache_dir=os.path.join(tree.work, "patch_cache",
                                                             "her2st_224"),
                                      device="cuda")
    img, spot = trainer.bleep_embeddings(model, sections)
    sizes = [s.num_spots for s in sections]
    _, pred = retrieval.retrieve_and_aggregate(
        np.concatenate(embed.split_by_section(spot, sizes)[1:]),
        np.concatenate([s.eval_expression for s in sections[1:]]),
        embed.split_by_section(img, sizes)[0], top_k=50, weight_ord=-1, device="cuda")
    hegs = metrics.heg_indices(sections[0].eval_expression)
    return int((pred[:, hegs].std(axis=0) == 0).sum())


def test_baseline_bleep(tree, panel, trained):
    """BLEEP (resnet50, 224 px, the weighted top-50 mode) on ``train``'s patch
    cache: finite scores, the HEG PCC NaN only where a HEG is predicted
    constant."""
    run = _run(tree, ["baseline", "--baseline", "bleep", "--patch-size", "224",
                      "--max_epochs", "1", "--bleep-retrieval", "weighted"] + tree.flags)
    _quiet(run.counts)
    scores = _printed_json(run.out)
    _finite(scores, ("hvg_pcc", "mse", "mae"))
    if not math.isfinite(scores["heg_pcc"]):
        assert _bleep_flat_hegs(tree, panel) > 0, scores


# --- torchrun -----------------------------------------------------------------------------------

def test_torchrun_train_and_baseline_dp(tree, trained, histogene):
    """``torchrun --nproc-per-node=1``, each with a fresh patch cache whose
    cooperative pre-cut launches extract_patches once per section: ``train``
    against the one-process ``train`` (14 steps each side, in TF32: every
    parameter within 2 lr a step, running statistics within
    DP_STAT_RTOL_LONG, the epoch loss within rtol DP_LOSS_RTOL_LONG);
    ``baseline --baseline histogene --dp`` (slide-DP pads every slide to the
    largest bucket, so each dropout mask is drawn at another shape) against
    the one-process run: finite, MSE and MAE within rtol 1e-2, the PCCs
    within 2e-2."""
    ref_scores = histogene[2]
    flags = tree.flags + ["--checkpoint-dir", "model_result_dp", "--patch-cache",
                          "patch_cache_dp"]
    train_counts = _run(tree, ["train", "--fold", "0", "--max_epochs", "1"] + flags,
                        ranks=1).counts
    run = _run(tree, ["baseline", "--baseline", "histogene", "--patch-size", "112",
                      "--max_epochs", "1", "--dp"] + flags, ranks=1)
    scores, dp_counts = _printed_json(run.out), run.counts
    rel = os.path.join("her2st", st_dataset.her2st_section_names(tree.root)[0], "best_0")
    got = checkpoint.restore_checkpoint(os.path.join(tree.work, "model_result_dp", rel))
    want = checkpoint.restore_checkpoint(os.path.join(tree.work, "model_result", rel))

    def epoch_losses(name):
        with open(os.path.join(tree.work, name, "train_log.jsonl")) as f:
            return [json.loads(line)["epoch_loss"] for line in f if "epoch_loss" in line]

    steps, lr = want["step"], 1e-4  # the CLI's default lr
    param, stat = state_diff(got["model"], want["model"])
    assert param <= 2 * lr * steps and stat <= DP_STAT_RTOL_LONG, (param, stat)
    loss_dp, loss_ref = epoch_losses("model_result_dp"), epoch_losses("model_result")
    assert got["step"] == steps and len(loss_dp) == 1
    assert math.isclose(loss_dp[0], loss_ref[0], rel_tol=DP_LOSS_RTOL_LONG), (loss_dp, loss_ref)
    _finite(scores)
    for k in ("mse", "mae"):
        assert math.isclose(scores[k], ref_scores[k], rel_tol=1e-2), (k, scores, ref_scores)
    for k in ("hvg_pcc", "heg_pcc"):
        assert abs(scores[k] - ref_scores[k]) <= 2e-2, (k, scores, ref_scores)
    assert [c["extract_patches"] for c in train_counts + dp_counts] == [len(tree.names)] * 2
    assert train_counts[0]["row_shift"] == shear_launches(steps), train_counts


def test_torchrun_shard_eval(tree, trained, evaluated):
    """``eval --shard-eval`` under torchrun (one rank per card) with a fresh
    patch cache: each rank logs itself, the cooperative pre-cut cuts each
    section once, the metrics within rtol 1e-6 of ``eval``'s."""
    world = torch.cuda.device_count()
    run = _run(tree, ["eval", "--fold", "0", "--shard-eval", "--patch-cache",
                      "patch_cache_shard", "--json", "shard.json"] + tree.flags, ranks=world)
    counts = run.counts
    ranks = [line for line in run.err.splitlines() if "eval --shard-eval: rank" in line]
    assert len(ranks) == world and len(counts) == world, (ranks, counts)
    assert sum(c["extract_patches"] for c in counts) == len(tree.names), counts
    sharded = _json(tree, "shard.json")
    for key, v in evaluated["avg"].items():
        assert math.isclose(sharded["avg"][key], v, rel_tol=1e-6), (key, sharded, evaluated)


# --- the data layer -----------------------------------------------------------------------------

def test_data_layer(card, tmp_path):
    """A HER2ST tree (4 sections of 300-700 spots x 2,000 genes, two of them
    gzipped) -> a 785-gene panel -> ``load_her2st(device="cuda")``: one
    launch per section, patches equal to ``extract_patches_np``, a second
    load from the cache with none; fold 0 trained and its metrics on the
    card host vs device (rtol 1e-4). A Visium tree (two sections, 10x
    triplets, PPM image.tif) -> ``load_visium``: one launch per section, BGR
    patches equal to ``extract_patches_np``; a ``PosRemap`` saved and loaded
    alike, and one raw-scale "tenx" step on the remapped sections."""
    import dataclasses

    from mclstexp_tpu_torch.config import PRESETS, her2st_config
    from mclstexp_tpu_torch.data import panel, visium
    from mclstexp_tpu_torch.data.io import gzip_in_place, load_slide
    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData
    from mclstexp_tpu_torch.data.posremap import PosRemap
    from mclstexp_tpu_torch.infer import embed, evaluate
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.train.state import create_train_state
    from mclstexp_tpu_torch.train.step import make_train_step
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    base = str(tmp_path)
    cfg = her2st_config(os.path.join(base, "model_result"))
    p = cfg.data.patch_size
    root = os.path.join(base, "her2st")
    sizes = [int(n) for n in np.random.default_rng(3).integers(300, 701, size=4)]
    names, _ = synthetic.write_st_layout(root, num_sections=4, num_spots=sizes,
                                         num_genes=2000, seed=0)
    for name in names[1::2]:
        gzip_in_place(st_dataset.her2st_cnt_path(root, name))
    sel = panel.select_panel(panel.her2st_count_frames(root), n_top_genes=1000,
                             panel_size=cfg.model.spot_dim)
    gene_panel = genes.load_panel("her2st", panel.save_panel_artifacts(
        sel, os.path.join(base, "panel"), "her2st"))
    assert len(gene_panel) == cfg.model.spot_dim

    reset_counts()
    cache = os.path.join(base, "patch_cache")
    sections = st_dataset.load_her2st(root, gene_panel, patch_size=p, cache_dir=cache,
                                      device="cuda")
    assert extract_patches.launches == len(names)
    for s in sections:
        want = extract_patches_np(load_slide(st_dataset.her2st_slide_path(root, s.name)),
                                  s.centers, p)
        assert np.array_equal(s.patches, want), s.name
    sections = st_dataset.load_her2st(root, gene_panel, patch_size=p, cache_dir=cache,
                                      device="cuda")
    assert extract_patches.launches == len(names)
    assert all(isinstance(s.patches, np.memmap) for s in sections)

    logger = MetricLogger(echo=False)
    state = train_fold(cfg, sections, fold=0, logger=logger, device="cuda")
    torch.cuda.synchronize()
    fold_losses = [r["loss"] for r in logger.records if "loss" in r]
    steps = num_train_steps(sum(s.num_spots for s in sections[1:]), cfg.train.batch_size)
    assert state.step == steps and all(math.isfinite(v) for v in fold_losses), fold_losses
    prepared = embed.prepare_eval_arrays(sections, device="cuda")
    img, spot = embed.compute_embeddings(state.model, sections, cfg.eval.batch_size,
                                         prepared=prepared, as_device=True, device="cuda")
    bounds = evaluate.section_bounds([s.num_spots for s in sections])
    args = (0, img, spot, prepared["eval_expression"], bounds, sections[0].eval_expression,
            cfg.eval.top_k, cfg.eval.weight_ord)
    host = evaluate.evaluate_fold_resident(*args, device="cuda")
    dev = evaluate.evaluate_fold_resident(*args, device_metrics=True, device="cuda")
    for k in host:
        assert math.isfinite(host[k]) and math.isfinite(dev[k])
        assert math.isclose(host[k], dev[k], rel_tol=1e-4, abs_tol=1e-5), (k, host, dev)

    vroot, prep = os.path.join(base, "visium"), os.path.join(base, "visium_prep")
    vnames = ("block1", "block2")
    vcfg = PRESETS["visium"]
    synthetic.write_visium_layout(vroot, vnames, num_spots=[700, 600], num_genes=1000,
                                  side=2000, seed=1)
    mdirs = {n: os.path.dirname(visium.visium_section_paths(vroot, prep, n)["barcode_path"])
             for n in vnames}
    vsel = panel.select_panel(panel.visium_count_frames(mdirs), n_top_genes=800,
                              panel_size=vcfg.model.spot_dim)
    visium.build_visium_preprocessed(mdirs, prep, vsel.panel)
    before = extract_patches.launches
    vsecs = visium.load_visium(vroot, prep, vnames, patch_size=p, device="cuda")
    assert extract_patches.launches == before + len(vnames)
    for s, n in zip(vsecs, vnames):
        want = extract_patches_np(visium.load_bgr(os.path.join(vroot, n, "image.tif")),
                                  s.centers, p)
        assert np.array_equal(s.patches, want) and s.num_genes == vcfg.model.spot_dim, n
    remap = PosRemap.build(vsecs)
    remap.save(os.path.join(base, "posremap.npz"))
    loaded = PosRemap.load(os.path.join(base, "posremap.npz"))
    assert loaded.vocab == remap.vocab and np.array_equal(loaded.x_values, remap.x_values)
    vsecs = remap.apply_sections(vsecs)
    mcfg = dataclasses.replace(vcfg.model, pos_vocab=remap.vocab)
    vstate = create_train_state(mcfg, vcfg.train, "cuda")
    data = DeviceResidentData(ConcatSections.from_sections(vsecs), "cuda")
    batch = data.take(list(range(vcfg.train.batch_size)))
    g = torch.Generator(device="cuda")
    draws = augment.sample_tenx_draws(augment.reseed(g, 0, 0, 0), vcfg.train.batch_size, "cuda")
    loss = float(make_train_step("tenx", tenx_raw_scale=vcfg.data.visium_raw_scale)(
        vstate, batch, draws))
    assert math.isfinite(loss)
