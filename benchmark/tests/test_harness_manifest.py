"""BENCHMARK.json against the benchmark's contract, and every piece of
every cell found by its name."""

import ast
import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

MANIFEST = harness.load_json(harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len(MANIFEST["command"]) <= 32
    assert len(harness.MANIFEST.read_bytes()) <= 64 * 1024
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_names_units_and_entry_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    for name in names:
        assert NAME.match(name), name
    metric_names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len(set(CELLS)) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_is_found_by_name(cell):
    c = harness.make_cell(MANIFEST, cell, 1, 1.0, False, "cpu")
    assert c.driver.run and c.builder.train_step and c.reference.parameter_specs
    assert set(c.checks["limits"]) and all(v > 0 for v in c.checks["limits"].values())
    for m in c.per_layer:
        assert harness.load_module("metrics", m["name"]).read
    keys = set(c.config) - {"assumed", "reduced"}
    reduced = next(x["reduced"] for x in MANIFEST["configs"] if x["name"] == c.config_name)
    assert set(reduced) <= keys


# (cell, config, its new traffic file, its end-to-end metric, the cell and
# traffic file it copies, what the new traffic file changes)
ADDED = [
    ("her2st-fold1-train", "mclstexp-her2st", "her2st-fold1", "train_spots_per_s",
     "her2st-train", "her2st-fold0", {"fold": 1}),
    ("histogene-grid48-slide", "histogene", "grid48-slide", "slide_spots_per_s",
     "histogene-visium-slide", "visium-slide", {"sections": {"grid": 48}}),
]


@pytest.mark.parametrize("name,config,traffic,metric,like,like_traffic,change", ADDED)
def test_a_cell_is_added_by_files_and_one_entry(tmp_path, monkeypatch, name, config, traffic,
                                                 metric, like, like_traffic, change):
    """A cell from a new traffic file and a new checks file (fold 1 of
    her2st; a 48 x 48 slide), one manifest entry and its name in its
    metric's list, with no file of the benchmark edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    base = json.loads((copy / "traffic" / f"{like_traffic}.json").read_text())
    (copy / "traffic" / f"{traffic}.json").write_text(json.dumps(dict(base, **change)))
    shutil.copy(copy / "checks" / f"{like}.json", copy / "checks" / f"{name}.json")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "added"})
    for m in manifest["end_to_end"]:
        if m["name"] == metric:
            m["workloads"].append(name)
    monkeypatch.setattr(harness, "BENCH", copy)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    cell = harness.make_cell(manifest, name, 3, 0.5, False, "cpu")
    cell.config = dict(cell.config, **tiny.CONFIGS[cell.config_name])
    cell.traffic = dict(cell.traffic, **tiny.TRAFFIC[like_traffic])
    result = tiny.run(cell)
    assert result["failed"] == 0 and metric in result["metrics"]
    assert all(c["value"] < 1e-4 for c in result["checks"].values())


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in {"torch", "numpy", "math", "contextlib", "typing",
                                              "__future__", "benchmark"}, (path.name, name)
                if name.startswith("benchmark"):
                    assert name == "benchmark.harness", (path.name, name)


def test_forbidden_names_are_compared_whole():
    mods = ["mclstexp_tpu_torch", "mclstexp_tpu_torch.ops", "jax_like", "flaxen", "torch"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["mclstexp_tpu.config"]) == ["mclstexp_tpu"]
    assert harness.forbidden_loaded(["jaxlib.xla_client", "jax", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    import subprocess
    import sys

    code = ("from benchmark.tests import tiny; from benchmark import harness; "
            "r = tiny.run(tiny.cell('her2st-serve')); "
            "print(harness.forbidden_loaded(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
