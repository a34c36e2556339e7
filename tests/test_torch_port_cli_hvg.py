"""``cli hvg`` of the port against the JAX CLI on a synthetic HER2ST tree.

``hvg --select-panel`` cuts the same panel from the counts, and ``hvg
--gene-panel`` writes the same per-section gene x spot matrices (within
atol 1e-6: the normalization runs in float64 on both sides, then float32).
The tree is the port's ``synthetic.write_st_layout`` (tables as pandas
writes them, PPM slides, which ``hvg`` never reads).
"""

import os

import numpy as np
import torch

from mclstexp_tpu.cli.main import main as jax_main
from mclstexp_tpu_torch.cli.main import main
from mclstexp_tpu_torch.data import synthetic

torch.set_num_threads(1)


def test_hvg_panel_and_matrices_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "her2st")
    names, genes = synthetic.write_st_layout(root, num_sections=3, num_spots=[40, 55, 31],
                                             num_genes=300, seed=2)
    panels = {}
    for tag, run, extra in (("port", main, ["--device", "cpu"]), ("jax", jax_main, [])):
        common = ["--dataset", "her2st", "--data-root", root] + extra
        assert run(["hvg", "--select-panel", "--n-top-genes", "60", "--panel-size", "48",
                    "--out", f"panel_{tag}"] + common) == 0
        printed = capsys.readouterr().out
        assert printed.startswith("panel: 48 genes -> ")
        panels[tag] = os.path.join(f"panel_{tag}", "her2st_hvg_panel.npy")
        assert run(["hvg", "--gene-panel", panels[tag], "--out", f"pre_{tag}"] + common) == 0
        capsys.readouterr()
    port_panel = np.load(panels["port"], allow_pickle=True)
    assert list(port_panel) == list(np.load(panels["jax"], allow_pickle=True))
    assert len(port_panel) == 48 and set(port_panel) <= set(genes)
    for name, n in zip(names, (40, 55, 31)):
        got = np.load(os.path.join("pre_port", "her2st", name, "preprocessed_matrix.npy"))
        want = np.load(os.path.join("pre_jax", "her2st", name, "preprocessed_matrix.npy"))
        assert got.shape == want.shape == (48, n) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
