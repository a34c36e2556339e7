"""Whole-slide training, one slide a step, fed as the port's
``baselines/trainer.py::train_baseline_fold`` feeds its step.

The slides (made on the device from the seed) are padded to the config's
bucket as the program's ``pad_slide`` pads them; each epoch walks them in
an order shuffled from the seed, each step's dropout generator reseeded by
(seed, epoch * 1000 + slide), and every step's loss is read, as the
program's loop reads it. Set-up warms each padded size on a copy of the
state, then takes the first ``checked_steps`` steps on the state the window
goes on with; after the window the reference follows those steps on the
slides' real spots.

Traffic keys: ``sections`` (``data.section_sizes``; {"grid": side} for one
side x side slide), ``fold`` (the section left out, or null),
``checked_steps``, ``trace_steps``, ``metric`` (the end-to-end metric of
the real spots trained over the window's seconds).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from benchmark import data, training
from benchmark.harness import ROOT, SetupParts, seed_int


def run(cell, t_start: float) -> dict:
    cfg, traffic, dev, seed = cell.config, cell.traffic, cell.device, cell.seed
    build, ref = cell.builder, cell.reference
    parts = SetupParts(t_start)
    import mclstexp_tpu_torch.baselines.trainer  # noqa: F401 (the port's import, timed apart)
    parts.mark("imports")
    sizes = data.section_sizes(traffic["sections"])
    if traffic.get("fold") is not None:
        sizes = [s for i, s in enumerate(sizes) if i != traffic["fold"]]
    rows = data.spots(sizes, cfg["patch_size"], cfg["n_genes"], seed, dev)
    slides = []
    for start, n in zip(data.offsets(sizes), sizes):
        real = {k: v[start:start + n] for k, v in rows.items()}
        slides.append((real, build.slide_batch(real, cfg["bucket"])))
    del rows
    training.sync(dev)
    parts.mark("slides on the card, the CUDA context first")
    weights = build.weights(cfg, seed, dev)
    state = build.train_state(cfg, weights, dev)
    step_fn = build.train_step(cfg)
    training.sync(dev)
    parts.mark("weights, model and optimizer")

    def generator(*key):
        return torch.Generator(device=dev).manual_seed(seed_int(seed, "dropout", *key))

    def schedule():
        epoch = 0
        while True:
            for j in np.random.default_rng(seed_int(seed, "slides", epoch)).permutation(len(slides)):
                yield epoch * 1000 + int(j), int(j)
            epoch += 1

    order = schedule()
    checked = [next(order) for _ in range(traffic["checked_steps"])]
    first_sizes = {slides[j][1]["mask"].shape[0] for _, j in checked}
    others = {}
    for j, (_, batch) in enumerate(slides):
        if batch["mask"].shape[0] not in first_sizes:
            others.setdefault(batch["mask"].shape[0], j)
    if others:  # the other padded sizes, on a copy of the state
        spare = copy.deepcopy(state)
        for j in others.values():
            float(step_fn(spare, slides[j][1], generator("warm", j)))
        del spare
    parts.mark("the other padded sizes warmed")

    prog = training.checked_steps(
        state, lambda t: step_fn(state, slides[checked[t][1]][1], generator(checked[t][0])),
        len(checked))
    training.sync(dev)
    parts.mark("the checked first steps (kernels built on a first run)")
    setup_s = time.perf_counter() - t_start

    def window_step(_):
        key, j = next(order)
        real, batch = slides[j]
        n = real["expression"].shape[0]
        return training.Step(n, build.slide_flops(cfg, n),
                             step_fn(state, batch, generator(key)), {"spots": n})

    trace_path = ROOT / "build" / "benchmark" / f"{cell.name}-trace.json" if cell.trace else None
    w = training.run_window(cell.seconds, window_step, dev, 1, trace_path, traffic["trace_steps"])
    peak = training.memory_peak(dev)
    parts.report()
    del state, step_fn
    training.free(dev)
    keys = data.trainable(build.specs(cfg))
    real = [slides[j][0] for _, j in checked]
    reference = ref.train_steps(weights, keys, cfg, real, [generator(key) for key, _ in checked])
    if cell.control:
        prog = ref.train_steps(weights, keys, cfg, real, [generator(key) for key, _ in checked],
                               cell.control)
    done = w.steps + w.traced
    return {
        "setup_s": setup_s,
        "end_to_end": {traffic["metric"]: sum(s.units for s in done) / w.elapsed},
        "attempted": len(done) + len(checked),
        "failed": w.nonfinite + sum(not np.isfinite(v) for v in prog["losses"]),
        "readings": training.readings(prog, reference),
        "memory_peak_bytes": peak,
        "layer": training.layer_context(w, ()),
    }
