"""The port's command line against the JAX package's, on the CPU.

* ``_build_config`` gives the JAX CLI's ``Config``, field for field, from
  the same argv;
* ``eval`` from shared weights (the JAX state saved with the JAX
  ``save_checkpoint``, the port's ``state.pt`` written from the same trees
  through ``interop``) prints the JAX CLI's four averages within rtol 1e-4,
  the LOO tolerance of ``test_torch_port_eval.py``;
* ``serve`` answers a POST as the service built from the same checkpoint;
* ``fetch`` prints its commands and runs none under ``--dry-run``;
* ``--help`` loads neither JAX nor the JAX package, and a command that needs
  the card fails without one unless ``--device cpu`` is given.

Every command runs in a fresh working directory (``eval`` writes
``prediction_result/`` beside it).
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.cli import main as jax_cli
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.train import checkpoint as jax_ckpt
from mclstexp_tpu.train.state import create_train_state as jax_create_train_state
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.cli import main as cli
from mclstexp_tpu_torch.core.layers import init_parameters
from mclstexp_tpu_torch.data import fetch as fetch_mod
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.infer import serve
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.train import checkpoint
from mclstexp_tpu_torch.train.state import TrainState, torch_adam

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _captured_args(module, argv, monkeypatch):
    seen = {}
    monkeypatch.setattr(module, "cmd_train", lambda args: seen.setdefault("args", args) and 0)
    module.main(argv)
    return seen["args"]


@pytest.mark.parametrize("argv", [
    ["train", "--dataset", "synthetic"],
    ["train", "--dataset", "her2st", "--encoder_name", "resnet50", "--max_epochs", "0",
     "--batch_size", "64", "--debug-nans", "--patch-size", "112"],
    ["train", "--dataset", "visium", "--no-pos-remap", "--dim", "300", "--lr", "3e-4",
     "--pretrained", "tower.pt", "--heads_layers", "1", "--checkpoint-dir", "ckpt"],
])
def test_build_config_matches_jax(argv, monkeypatch):
    got = cli._build_config(_captured_args(cli, argv, monkeypatch))
    want = jax_cli._build_config(_captured_args(jax_cli, argv, monkeypatch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.get_config("cscc") is config.PRESETS["cscc"]
    with pytest.raises(KeyError, match="unknown preset"):
        config.get_config("nope")


def _jax_state():
    cfg = jax_config.get_config("synthetic")
    s = jax_synthetic.make_dataset(patch_size=cfg.data.patch_size)[0]
    sample = {"image": s.patches[:2].astype(np.float32) / 255.0,
              "expression": s.expression[:2], "position": s.positions[:2]}
    _, state = jax_create_train_state(cfg.model, cfg.train, sample)
    return cfg, state


def _port_checkpoint(path, params, batch_stats):
    cfg = config.get_config("synthetic").model
    model = MclSTExp(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, batch_stats, cfg), strict=True)
    return checkpoint.save_checkpoint(
        path, TrainState(model, torch_adam(model.parameters(), 1e-4, 1e-3)))


def test_eval_from_shared_weights_prints_the_jax_averages(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg, state = _jax_state()
    name = jax_synthetic.make_dataset(patch_size=32)[0].name
    assert name == synthetic.make_dataset(patch_size=32)[0].name
    params, stats = jax.device_get(state.params), jax.device_get(state.batch_stats)
    jax_ckpt.save_checkpoint(
        jax_ckpt.fold_checkpoint_dir("jax_ckpt", "synthetic", name, 0), state)
    _port_checkpoint(checkpoint.fold_checkpoint_dir("port_ckpt", "synthetic", name, 0),
                     params, stats)
    common = ["eval", "--dataset", "synthetic", "--fold", "0"]
    assert jax_cli.main(common + ["--checkpoint-dir", "jax_ckpt", "--json", "jax.json"]) == 0
    jax_out = capsys.readouterr().out
    assert cli.main(common + ["--checkpoint-dir", "port_ckpt", "--device", "cpu",
                              "--json", "port.json"]) == 0
    port_out = capsys.readouterr().out
    with open("jax.json") as f:
        want = json.load(f)
    with open("port.json") as f:
        got = json.load(f)
    assert got["folds"] == want["folds"] == [0]
    assert got["avg"].keys() == want["avg"].keys() == {"hvg_pcc", "heg_pcc", "mse", "mae"}
    for k, v in want["avg"].items():
        assert np.isfinite(got["avg"][k])
        np.testing.assert_allclose(got["avg"][k], v, rtol=1e-4, err_msg=k)
    assert [line.split(":")[0] for line in port_out.splitlines()] == [
        line.split(":")[0] for line in jax_out.splitlines()]


def test_serve_answers_a_post_as_the_service(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    sections = synthetic.make_dataset(patch_size=32)
    cfg = config.get_config("synthetic").model
    model = MclSTExp(cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(4))
    ckpt_dir = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(ckpt_dir, TrainState(model, torch_adam(model.parameters(), 1, 0)))

    servers = []
    make_server = serve.make_server
    monkeypatch.setattr(serve, "make_server",
                        lambda *a, **kw: servers.append(make_server(*a, **kw)) or servers[-1])
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("rc", cli.main(
        ["serve", "--dataset", "synthetic", "--checkpoint", ckpt_dir, "--port", "0",
         "--exclude-fold", "1", "--device", "cpu"])), daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while not servers and t.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert servers, "the server did not start"
    server = servers[0]
    try:
        host, port = server.server_address[:2]
        patches = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        req = urllib.request.Request(
            f"http://{host}:{port}/predict",
            data=json.dumps({"patches": patches.tolist()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["result"], np.float32)
    finally:
        server.shutdown()
        t.join(timeout=30)
    assert not t.is_alive() and result["rc"] == 0
    banner = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    loaded = MclSTExp(cfg, device="cpu")
    checkpoint.load_checkpoint(ckpt_dir, loaded)
    service = serve.PredictionService.from_sections(
        loaded, sections, batch_size=16, exclude_section=1, top_k=8, patch_size=32,
        device="cpu")
    try:
        info = service.info()  # before a prediction, as the banner's counters are
        want = service.predict(patches)
    finally:
        service.close()
    assert banner == {"serving": f"http://{host}:{port}", **info}
    np.testing.assert_array_equal(got, want)


def test_fetch_commands_and_hints():
    her = fetch_mod.fetch_commands("her2st", "/d")
    assert her == [["git", "clone", fetch_mod.HER2ST_GIT, "/d/her2st"]]
    cscc = fetch_mod.fetch_commands("cscc", "/d")
    assert cscc[0][0] == "curl" and fetch_mod.CSCC_TAR_URL in cscc[0]
    assert cscc[1][0] == "tar"
    assert fetch_mod.fetch_commands("visium", "/d") == []
    with pytest.raises(ValueError, match="unknown dataset"):
        fetch_mod.fetch_commands("nope", "/d")
    from mclstexp_tpu.data import fetch as jax_fetch

    for ds in ("her2st", "cscc", "visium"):
        assert fetch_mod.fetch_commands(ds, "/d") == jax_fetch.fetch_commands(ds, "/d")
        hint = fetch_mod.next_steps(ds, "/d")
        assert hint == jax_fetch.next_steps(ds, "/d").replace(
            "python -m mclstexp_tpu.cli", "python -m mclstexp_tpu_torch.cli")
        assert "mclstexp_tpu_torch.cli" in hint


def test_fetch_cli_dry_run_runs_nothing(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(fetch_mod.subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    for ds, needle in (("her2st", "git clone"), ("cscc", "curl"),
                       ("visium", "10xgenomics.com")):
        assert cli.main(["fetch", ds, "--dest", str(tmp_path), "--dry-run"]) == 0
        out = capsys.readouterr().out
        assert needle in out and "--data-root" in out
    assert calls == []


def test_fetch_runs_each_command_and_stops_at_a_failure(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(fetch_mod.subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    assert cli.main(["fetch", "cscc", "--dest", str(tmp_path / "dl")]) == 0
    assert calls == fetch_mod.fetch_commands("cscc", str(tmp_path / "dl"))
    assert (tmp_path / "dl").is_dir()
    assert "GSE144240_RAW" in capsys.readouterr().out
    calls.clear()
    monkeypatch.setattr(fetch_mod.subprocess, "call", lambda cmd: calls.append(cmd) or 7)
    assert cli.main(["fetch", "cscc", "--dest", str(tmp_path / "dl")]) == 7
    assert len(calls) == 1
    assert "fetch step failed (exit 7)" in capsys.readouterr().out


def test_help_loads_no_jax_and_lists_the_subcommands():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "mclstexp_tpu_torch.cli", "--help"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("hvg", "train", "eval", "predict", "serve", "baseline", "export-torch",
                "fetch"):
        assert cmd in out.stdout
    assert "bench" not in out.stdout
    code = (
        "import runpy, sys\n"
        "sys.argv = ['mclstexp_tpu_torch.cli', 'train', '--help']\n"
        "try:\n"
        "    runpy.run_module('mclstexp_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mclstexp_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and out.stdout.rstrip().endswith("clean")


def test_commands_run_on_the_card_unless_told_otherwise(tmp_path, monkeypatch):
    """Without a card the default ``--device cuda`` fails in torch (``train``,
    ``baseline``); it never falls back to the CPU. A dtype other than
    float32 or bfloat16 is refused (argparse's choices)."""
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CPU-only failure cannot show")
    argv = ["train", "--dataset", "synthetic", "--fold", "0", "--max_epochs", "1"]
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(argv)
    assert not (tmp_path / "model_result" / "synthetic").exists()
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["baseline", "--baseline", "histogene", "--dataset", "synthetic",
                  "--n-layers", "1", "--max_epochs", "1"])
    assert not (tmp_path / "model_result" / "baselines").exists()
    with pytest.raises(SystemExit):
        cli.main(argv + ["--device", "cpu", "--dtype", "float16"])


@pytest.fixture(scope="module")
def bf16_fold(tmp_path_factory):
    """A working directory holding the synthetic preset's fold 0 trained by
    ``train --dtype bfloat16`` (one epoch, on the CPU)."""
    work = tmp_path_factory.mktemp("bf16_cli")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert cli.main(["train", "--dataset", "synthetic", "--fold", "0", "--device", "cpu",
                         "--max_epochs", "1", "--dtype", "bfloat16"]) == 0
    finally:
        os.chdir(cwd)
    fold_dir = next((work / "model_result" / "synthetic").glob("*/best_0"))
    assert (fold_dir / checkpoint.STATE_FILE).is_file()
    return work, fold_dir


class _NoServer:
    """What ``make_server`` returns in place of an HTTP server: it serves
    nothing and returns at once."""
    server_address = ("127.0.0.1", 0)

    def serve_forever(self):
        pass

    def server_close(self):
        pass


@pytest.mark.parametrize("command", ["eval", "predict", "serve"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["no-dtype", "bfloat16"])
def test_train_and_eval_in_bfloat16(bf16_fold, command, dtype, monkeypatch):
    """After ``train --dtype bfloat16``, ``eval``, ``predict`` and ``serve``
    build their model in ``--dtype``'s type (float32 without the flag), the
    dtype JAX's ``_build_config`` gives on the same argv, and run to the end
    on it."""
    from mclstexp_tpu_torch.train import state as state_mod

    work, fold_dir = bf16_fold
    monkeypatch.chdir(work)
    argv = [command, "--dataset", "synthetic", "--fold", "0"]
    argv += {"eval": ["--json", "out.json"], "predict": ["--checkpoint", str(fold_dir)],
             "serve": ["--checkpoint", str(fold_dir), "--port", "0"]}[command]
    if command == "serve":
        argv.remove("--fold"), argv.remove("0")
    argv += [] if dtype is None else ["--dtype", dtype]
    built = []
    create = state_mod.create_train_state

    def spy(model_cfg, *args, **kw):
        built.append(model_cfg.dtype)
        return create(model_cfg, *args, **kw)

    monkeypatch.setattr(state_mod, "create_train_state", spy)
    monkeypatch.setattr(serve, "make_server", lambda *a, **kw: _NoServer())
    assert cli.main(argv + ["--device", "cpu"]) == 0
    seen = {}
    monkeypatch.setattr(jax_cli, f"cmd_{command}", lambda args: seen.setdefault("args", args)
                        and 0)
    jax_cli.main(argv)
    want = jax_cli._build_config(seen["args"]).model.dtype
    assert built == [want] == [dtype or "float32"]
    if command == "eval":
        avg = json.loads((work / "out.json").read_text())["avg"]
        assert all(np.isfinite(v) for v in avg.values())


def test_reference_data_root_falls_back_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("MCLSTEXP_REFERENCE_DATA", raising=False)
    fallback = config.REFERENCE_DATA_FALLBACK
    monkeypatch.setattr(os.path, "isdir", lambda p: p == fallback)
    assert config.reference_data_root() == jax_config.reference_data_root() == fallback
    monkeypatch.setenv("MCLSTEXP_REFERENCE_DATA", str(tmp_path))
    monkeypatch.setattr(os.path, "isdir", lambda p: p in (fallback, str(tmp_path)))
    assert config.reference_data_root() == jax_config.reference_data_root() == str(tmp_path)
    monkeypatch.setattr(os.path, "isdir", lambda p: False)
    assert config.reference_data_root() is None is jax_config.reference_data_root()
