"""Where the time of one train step goes, at the her2st widths, on the card.

    python -m mclstexp_tpu_torch.profile_step [--slide [histogene|hist2st]] [--side N]
        [--dtype float32|bfloat16] [--dp]

Builds the her2st-width model (densenet121, 224 px, spot_dim 785,
pos_vocab 1024, 2 blocks of 8x64 heads, projection 256, batch 128) from a
seed on synthetic sections, warms up, times 10 steps on the host clock
(ending in a synchronize), then records 3 steps with ``torch.profiler``.
With ``--slide``, the step is instead one whole-slide HisToGene step with
``attn_backend="flash"`` at the her2st flow's widths (dim 1024, 8 layers of
16 x 64 heads, 112 px, 785 genes) on a 63 x 63 grid of random spots
(3,969, padded to 4,096 rows: attention (1, 16, 4,096, 64) with segment
ids), from a seed; ``--slide hist2st`` the same slide (with random counts)
through one Hist2ST step at the reference widths (dim 1,024, 16 x 64 heads,
depths 2 / 8 / 4, zinb 0.25, bake 5: six train-mode passes), and ``--side
N`` an N x N grid instead. ``--dtype`` is the model's compute dtype
(default float32). ``--dp``: the flagship step data-parallel over a
one-rank group on this card (``parallel.mesh.make_mesh``; the global batch
norms, the gathered loss, the gradient all-reduce), what the data-parallel
step costs before any card is added. Prints one JSON object:
  * ``ms_per_step``: host wall time per step, unprofiled;
  * ``device_busy_ms_per_step`` and ``idle_share``: the union of kernel
    intervals against the profiled window;
  * ``phases``: device time of the kernels launched inside each of the
    step's named ranges (augment, forward, backward, optimizer);
  * ``categories`` and ``top_kernels``: device time by kernel family/name.
Needs a CUDA card; the Chrome trace goes to
``<checkout>/build/profile_step_trace.json``. To compare a parent commit
in one chip call, unpack it into ``build/parent``, copy this file into its
package and run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import time

import numpy as np
import torch

from mclstexp_tpu_torch.config import her2st_config
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops.build import BUILD_DIR
from mclstexp_tpu_torch.train.state import create_train_state
from mclstexp_tpu_torch.train.step import make_train_step

PHASES = ("augment", "forward", "backward", "optimizer")
TIMED_STEPS, PROFILED_STEPS = 10, 3
SLIDE_SIDE = 63  # the whole slide: a 63 x 63 grid, 3,969 spots
SLIDE_FAMILIES = ("histogene", "hist2st")
TRACE = BUILD_DIR.parent / "profile_step_trace.json"  # <checkout>/build/
# First match wins: cuDNN's batch-norm and convolution kernels share the
# "cudnn" prefix, and its convolutions also carry "gemm" in their names.
CATEGORIES = (
    ("flash", r"flash_"),
    ("row_shift", r"shift_rows|shift_cols"),
    ("batch_norm", r"batch_norm|batchnorm|bn_fw|bn_bw|welford"),
    ("layout_transpose", r"nchwToNhwc|nhwcToNchw"),
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit"),
    ("matmul", r"gemm|cutlass|cublas|splitK"),
    ("optimizer", r"multi_tensor|adam"),
    ("copy_cat", r"[Cc]at|[Cc]opy"),
    ("reduce", r"reduce|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def _category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarize(trace: dict, steps: int, phases=PHASES) -> dict:
    """Device time by phase (the ``record_function`` ranges named in
    ``phases``), category and kernel from a Chrome trace."""
    events = trace["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in phases]
    phase_us = collections.Counter()
    cat_us = collections.Counter()
    name_us, name_n = collections.Counter(), collections.Counter()
    for k in kernels:
        t = launches.get(k["args"].get("correlation"))
        phase = next((n for n, s, e in ranges if t is not None and s <= t <= e), "outside")
        phase_us[phase] += k["dur"]
        cat_us[_category(k["name"])] += k["dur"]
        name_us[k["name"]] += k["dur"]
        name_n[k["name"]] += 1
    busy = _union_us((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    window = (max(k["ts"] + k["dur"] for k in kernels) - min(k["ts"] for k in kernels))
    per = 1e-3 / steps
    return {
        "device_busy_ms_per_step": busy * per,
        "window_ms_per_step": window * per,
        "idle_share": 1.0 - busy / window,
        "kernels_per_step": len(kernels) / steps,
        "phases": {p: phase_us[p] * per for p in (*phases, "outside") if p in phase_us},
        "categories": {c: u * per for c, u in cat_us.most_common()},
        "top_kernels": [{"name": n[:120], "ms_per_step": u * per, "launches_per_step":
                         name_n[n] / steps} for n, u in name_us.most_common(15)],
    }


def flagship_step(dtype: str, dp: bool = False):
    """run(i) of one her2st-width train step (with ``dp``, over a one-rank
    group), and its phases."""
    cfg = her2st_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
    sections = synthetic.make_dataset(num_sections=2, num_spots=128,
                                      num_genes=cfg.model.spot_dim,
                                      patch_size=cfg.data.patch_size, seed=0)
    data = DeviceResidentData(ConcatSections.from_sections(sections), "cuda")
    state = create_train_state(cfg.model, cfg.train, "cuda")
    step = make_train_step("st", rot_impl=cfg.train.rot_impl)
    g = torch.Generator(device="cuda").manual_seed(0)
    b = cfg.train.batch_size
    shard = None
    if dp:
        from mclstexp_tpu_torch.parallel.mesh import make_mesh
        from mclstexp_tpu_torch.train.step import batch_shard

        shard = batch_shard(make_mesh(device="cuda"), b)

    def run(i):
        idx = np.arange(i * b, (i + 1) * b) % len(data.expression)
        return step(state, data.take(idx), augment.sample_st_draws(g, b, "cuda"), None, shard)
    return run, PHASES


def slide_step(dtype: str, family: str = "histogene", side: int = SLIDE_SIDE):
    """run(i) of one whole-slide step of ``family`` with "flash", and its
    phases (none: the slide step names no ranges)."""
    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.data.section import Section

    cfg = trainer.BaselineConfig(model=family, n_genes=785, patch_size=112,
                                 n_layers=8 if family == "histogene" else None, max_epochs=1,
                                 dtype=dtype)
    n = side * side
    rng = np.random.default_rng(31)
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
    grid = grid.reshape(-1, 2).astype(np.int32)
    whole = Section("whole", rng.normal(size=(n, 785)).astype(np.float32), grid, grid,
                    patches=rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8),
                    counts=rng.poisson(2.0, (n, 785)).astype(np.float32))
    batch = trainer.slide_tensors(trainer.pad_slide(whole, cfg.bucket, family == "hist2st",
                                                    cfg), "cuda")
    state = trainer.init_baseline(cfg, "cuda", "flash")
    step = trainer.make_slide_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return (lambda i: step(state, batch, gen)), ()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="profile_step")
    parser.add_argument("--slide", nargs="?", const="histogene", choices=SLIDE_FAMILIES)
    parser.add_argument("--side", type=int, default=SLIDE_SIDE)
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument("--dp", action="store_true",
                        help="the flagship step over a one-rank process group")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")

    run, phases = (slide_step(args.dtype, args.slide, args.side) if args.slide
                   else flagship_step(args.dtype, args.dp))
    for i in range(3):
        run(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        run(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(PROFILED_STEPS):
            run(i)
        torch.cuda.synchronize()
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    with open(TRACE) as f:
        summary = summarize(json.load(f), PROFILED_STEPS, phases)
    what = f"{args.slide} slide of {args.side}x{args.side} spots" if args.slide else \
        "her2st flagship" + (" over a one-rank group" if args.dp else "")
    print(json.dumps({"step": what,
                      "dtype": args.dtype, "ms_per_step": ms, "timed_steps": TIMED_STEPS,
                      "profiled_steps": PROFILED_STEPS, "device": torch.cuda.get_device_name(0),
                      **summary}, indent=1))
    if args.dp:
        from mclstexp_tpu_torch.parallel import distributed

        distributed.shutdown()


if __name__ == "__main__":
    main()
