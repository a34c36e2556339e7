"""Test-sized configurations and mixes (the CPU tests' stand-ins for the
cells' files), and a way to run a cell on the CPU with them."""

from __future__ import annotations

import time

from benchmark import harness
from benchmark.run import run_cell

SECTIONS = {"count": 4, "low": 20, "high": 40, "seed": 5}
CONFIGS = {
    "mclstexp-her2st": {
        "encoder_name": "tiny_densenet", "block_config": [2, 2], "growth_rate": 4, "bn_size": 2,
        "init_features": 8, "image_dim": 16, "patch_size": 32, "spot_dim": 32,
        "projection_dim": 32, "heads_num": 2, "heads_dim": 8, "pos_vocab": 64,
        "batch_size": 16, "log_every": 2, "eval_batch_size": 8, "top_k": 8, "max_batch": 16},
    # the program's HisToGene keeps its width (1,024, 16 heads) whatever the config
    "histogene": {"n_genes": 16, "patch_size": 8, "n_layers": 1, "bucket": 16},
}
TRAFFIC = {
    "her2st-fold0": {"sections": SECTIONS, "trace_steps": 2},
    "her2st-slides": {"sections": SECTIONS, "trace_steps": 3},
    "visium-slide": {"sections": {"grid": 6}, "trace_steps": 2},
    "her2st-overload": {"sections": SECTIONS, "rate_per_s": 20,
                         "sizes": [[1, 0.6], [3, 0.3], [16, 0.1]], "block": 10, "pool": 32, "clients": 4,
                         "drain_s": 10, "calibration_patches": 8, "check_per_size": 2,
                         "trace_s": 0.3},
}


def cell(name: str, seed: int = 7, seconds: float = 1.0, trace: bool = False) -> harness.Cell:
    c = harness.make_cell(harness.load_json(harness.MANIFEST), name, seed, seconds, trace,
                          device="cpu")
    c.config = dict(c.config, **CONFIGS[c.config_name])
    c.traffic = dict(c.traffic, **TRAFFIC[c.traffic_name])
    return c


def run(c: harness.Cell) -> dict:
    return run_cell(c, time.perf_counter())
