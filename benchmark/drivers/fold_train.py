"""A training fold of a two-tower model, fed as the port's
``train/loop.py::train_fold`` feeds its step.

The fold's training sections stay on the device in the program's
``DeviceResidentData`` (made there from the seed, not copied from the
host); each step gathers one shuffled batch with its ``take`` (the partial
batch of each epoch kept), draws the batch's augmentation from a generator
reseeded by (seed, epoch, step), and calls the program's step; losses are
read every ``log_every`` steps. Set-up warms the partial batch's shape on
a copy of the state, then takes the first ``checked_steps`` steps of the
fold on the state the window goes on with; after the window the
reference follows those steps.

Traffic keys: ``sections`` (``data.section_sizes``), ``fold`` (the section
left out), ``checked_steps``, ``trace_steps``, ``metric`` (the end-to-end
metric of the spots trained over the window's seconds).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from benchmark import data, training
from benchmark.harness import ROOT, SetupParts, seed_int


def resident_data(rows, device):
    """The program's ``DeviceResidentData`` holding tensors made on the
    device (its constructor copies host arrays)."""
    from mclstexp_tpu_torch.data.pipeline import DeviceResidentData

    resident = DeviceResidentData.__new__(DeviceResidentData)
    resident.n, resident.device = len(rows["expression"]), torch.device(device)
    resident.patches, resident.expression = rows["image_u8"], rows["expression"]
    resident.positions = rows["position"]
    return resident


def run(cell, t_start: float) -> dict:
    cfg, traffic, dev, seed = cell.config, cell.traffic, cell.device, cell.seed
    build, ref = cell.builder, cell.reference
    parts = SetupParts(t_start)
    import mclstexp_tpu_torch.train.step  # noqa: F401 (the port's import, timed apart)
    parts.mark("imports")
    sizes = data.section_sizes(traffic["sections"])
    train_sizes = [s for i, s in enumerate(sizes) if i != traffic["fold"]]
    rows = data.spots(train_sizes, cfg["patch_size"], cfg["spot_dim"], seed, dev)
    resident = resident_data(rows, dev)
    training.sync(dev)
    parts.mark("data on the card, the CUDA context first")
    weights = build.weights(cfg, seed, dev)
    state = build.train_state(cfg, weights, dev)
    step_fn = build.train_step(cfg)
    training.sync(dev)
    parts.mark("weights, model and optimizer")
    gen = torch.Generator(device=dev)
    n, bsz = resident.n, cfg["batch_size"]

    def schedule():
        epoch = 0
        while True:
            for i, idx in enumerate(data.epoch_order(n, bsz, seed, epoch)):
                yield epoch, i, idx
            epoch += 1

    order = schedule()

    def feed(idx, key):
        batch = resident.take(idx)
        gen.manual_seed(seed_int(seed, "draws", *key))
        program_draws, ref_draws = build.draws(cfg, len(idx), gen, dev)
        return batch, program_draws, ref_draws

    if n % bsz:  # the partial batch's shape, on a copy of the state
        spare = copy.deepcopy(state)
        batch, program_draws, _ = feed(np.arange(n % bsz), ("warm",))
        float(step_fn(spare, batch, program_draws, gen))
        del spare, batch
    parts.mark("the partial batch's shape warmed (kernels built on a first run)")
    kept = []

    def first_step(_):
        epoch, i, idx = next(order)
        batch, program_draws, ref_draws = feed(idx, (epoch, i))
        kept.append((build.batch_of(batch), ref_draws))
        return step_fn(state, batch, program_draws, gen)

    prog = training.checked_steps(state, first_step, traffic["checked_steps"])
    training.sync(dev)
    parts.mark("the checked first steps")
    setup_s = time.perf_counter() - t_start

    def window_step(_):
        epoch, i, idx = next(order)
        batch, program_draws, _ = feed(idx, (epoch, i))
        return training.Step(len(idx), build.train_flops(cfg, len(idx)),
                             step_fn(state, batch, program_draws, gen))

    trace_path = ROOT / "build" / "benchmark" / f"{cell.name}-trace.json" if cell.trace else None
    w = training.run_window(cell.seconds, window_step, dev, cfg["log_every"], trace_path,
                            traffic["trace_steps"])
    peak = training.memory_peak(dev)
    parts.report()
    del state, resident, rows
    training.free(dev)
    keys = data.trainable(build.specs(cfg))
    batches, draws = [b for b, _ in kept], [d for _, d in kept]
    reference = ref.train_steps(weights, keys, cfg, batches, draws)
    if cell.control:
        prog = ref.train_steps(weights, keys, cfg, batches, draws, cell.control)
    done = w.steps + w.traced
    return {
        "setup_s": setup_s,
        "end_to_end": {traffic["metric"]: sum(s.units for s in done) / w.elapsed},
        "attempted": len(done) + len(kept),
        "failed": w.nonfinite + sum(not np.isfinite(v) for v in prog["losses"]),
        "readings": training.readings(prog, reference),
        "memory_peak_bytes": peak,
        "layer": training.layer_context(w, ("augment", "forward", "backward", "optimizer")),
    }
