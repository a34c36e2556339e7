#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases, in
order; any failure exits non-zero and prints no result line:
  1. device: the card, its power limit, the TF32 flags;
  2. build: the CUDA kernel source of the port, compiled with nvcc for
     sm_90a;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the main path gives it (bit-equal), in each of its layouts, with its
     time, the plain version's time, a one-call PyTorch yardstick and the
     memory bound;
  4. train: ``train_fold`` at the her2st widths (densenet121, 224 px,
     spot_dim 785, pos_vocab 1024, 2 blocks of 8x64 heads, projection 256,
     batch 128) on synthetic sections made from a seed, one epoch of three
     full batches and a remainder; every loss finite, and every kernel of
     the path launched (row_shift three times per step: twice in its row
     layout, once in its column layout);
  5. reference: the trained model on the card against the same weights on
     the CPU at a small batch (TF32 off for the comparison);
  6. step time: steady-state ms per train step.
The line before the last is a JSON object with one entry per kernel and
layout; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FLAGSHIP = (128, 224, 224, 3)  # the Paeth shears' images at the her2st widths


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} python={sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {card_line()}")
    log(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build():
    from mclstexp_tpu_torch.ops import build, row_shift

    t0 = time.perf_counter()
    path, out = build.build_library(row_shift.SOURCE)
    log(f"[build] {row_shift.SOURCE} -> {path}")
    for line in out.strip().splitlines():
        log(f"[build]   {line}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")


def _shifts(g, b, h, w):
    """Random shifts with the clamp edges +-W//2 and values beyond them."""
    import torch

    k = torch.randint(-w, w + 1, (b, h), generator=g, device="cuda", dtype=torch.int32)
    edges = torch.tensor([0, w // 2, -(w // 2), w // 2 + 1, -(w // 2) - 1, w, -w, 3 * w],
                         device="cuda", dtype=torch.int32)
    k.view(-1)[: len(edges)] = edges
    return k


def _padded(view, pad):
    """``view`` zero-padded by ``pad`` on both sides of W, in the view's layout."""
    import torch.nn.functional as F

    if view.is_contiguous():
        return F.pad(view, (0, 0, pad, pad))
    return F.pad(view.transpose(1, 2), (0, 0, 0, 0, pad, pad)).transpose(1, 2)


def phase_kernels() -> list:
    """row_shift against its plain version at the flagship shape, in both of
    its layouts: "rows" (contiguous image: the Paeth row shears, kernel
    ``shift_rows``) and "cols" (the transposed view: the column shear, kernel
    ``shift_cols``). One entry per layout, timed in float32, the main path's
    type; bfloat16 is checked and timed too."""
    import torch

    from mclstexp_tpu_torch.ops.row_shift import row_shift, row_shift_plain

    b, h, w, c = FLAGSHIP
    g = torch.Generator(device="cuda").manual_seed(0)
    k = _shifts(g, b, h, w)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.rand(FLAGSHIP, generator=g, device="cuda").to(dtype)
        for layout, view in (("rows", x), ("cols", x.transpose(1, 2))):
            got, want = row_shift(view, k), row_shift_plain(view, k)
            torch.cuda.synchronize()
            if got.stride() != view.stride() or not torch.equal(got, want):
                raise AssertionError(f"row_shift {layout} {dtype} differs from its plain version")
            err = float((got.float() - want.float()).abs().max())
            ms = cuda_ms(lambda: row_shift(view, k))
            plain_ms = cuda_ms(lambda: row_shift_plain(view, k), iters=20)
            nbytes = 2 * x.numel() * x.element_size() + k.numel() * 4
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            # Yardstick: one torch.gather over a zero-padded copy in the same
            # layout computes the same function (the pad is set-up, untimed).
            pad = w // 2
            xp = _padded(view, pad)
            src = (torch.arange(w, device="cuda") - k.long().clamp(-pad, pad)[..., None]
                   + pad)[..., None].expand(b, h, w, c)
            if not torch.equal(torch.gather(xp, 2, src), want):
                raise AssertionError("gather yardstick computes another function")
            library_ms = cuda_ms(lambda: torch.gather(xp, 2, src))
            log(f"[kernels] row_shift {layout} {str(dtype)[6:]} {FLAGSHIP}: bit-equal; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.gather {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound")
            if dtype == torch.float32:
                entries[layout] = {
                    "name": f"row_shift[{layout}]", "route": "cuda",
                    "source": "mclstexp_tpu_torch/csrc/row_shift.cu",
                    "replaces": "mclstexp_tpu/ops/pallas_shift.py:36",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes", "library_ms": library_ms, "max_abs_err": err}
            else:
                entries[layout]["max_abs_err"] = max(entries[layout]["max_abs_err"], err)
    return [entries["rows"], entries["cols"]]


def phase_train():
    import torch

    from mclstexp_tpu_torch.config import her2st_config
    from mclstexp_tpu_torch.data import synthetic
    from mclstexp_tpu_torch.data.pipeline import num_train_steps
    from mclstexp_tpu_torch.ops.row_shift import row_shift
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = her2st_config(os.path.join(root, "build", "chip_smoke", "model_result"))
    m = cfg.model
    log(f"[train] model {m.encoder_name} image_dim={m.image_dim} spot_dim={m.spot_dim} "
        f"pos_vocab={m.pos_vocab} blocks={m.head_layers}x{m.heads_num}x{m.heads_dim} "
        f"projection={m.projection_dim} batch={cfg.train.batch_size}")
    t0 = time.perf_counter()
    # 2 training sections of 225 spots: 450 = 3 full batches of 128 + 66
    sections = synthetic.make_dataset(num_sections=3, num_spots=225, num_genes=m.spot_dim,
                                      patch_size=cfg.data.patch_size, seed=0)
    log(f"[train] synthetic sections made in {time.perf_counter() - t0:.1f} s")
    n_train = sum(s.num_spots for s in sections[1:])
    steps = num_train_steps(n_train, cfg.train.batch_size)

    row_shift.launches = 0
    row_shift.layout_launches = {"rows": 0, "cols": 0}
    logger = MetricLogger(echo=True)
    t0 = time.perf_counter()
    state = train_fold(cfg, sections, fold=0, logger=logger, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(row_shift.layout_launches)

    losses = [r["loss"] for r in logger.records if "loss" in r]
    if state.step != steps or len(losses) != steps:
        raise AssertionError(f"expected {steps} steps, took {state.step} ({len(losses)} logged)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if row_shift.launches != 3 * steps or launches != {"rows": 2 * steps, "cols": steps}:
        raise AssertionError(f"row_shift launched {row_shift.launches} times ({launches}) in "
                             f"{steps} steps; the Paeth rotation takes 3 per step, two "
                             "row shears and one column shear")
    log(f"[train] train_fold: {steps} steps ({n_train} spots, remainder "
        f"{n_train % cfg.train.batch_size}) in {seconds:.1f} s incl. set-up; "
        f"running losses {losses}; row_shift launches {row_shift.launches} {launches}")
    return cfg, state, sections, launches


def phase_reference(cfg, state, sections):
    """The card's forward against the same weights on the CPU (eval mode)."""
    import torch

    from mclstexp_tpu_torch.models.mclstexp import MclSTExp

    s = sections[0]
    batch = {"image": torch.from_numpy(s.patches[:4]).float() / 255.0,
             "expression": torch.from_numpy(s.expression[:4]),
             "position": torch.from_numpy(s.positions[:4]).long()}
    ref = MclSTExp(cfg.model, device="cpu")
    ref.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()}, strict=True)
    ref.eval()
    state.model.eval()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = state.model({k: v.cuda() for k, v in batch.items()})
            want = ref(batch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for name, g, w in zip(("image", "spot"), got, want):
        g = g.cpu()
        if g.shape != (4, cfg.model.projection_dim) or not torch.isfinite(g).all():
            raise AssertionError(f"{name} embedding: shape {tuple(g.shape)} or non-finite")
        err = float((g - w).abs().max())
        log(f"[reference] {name} embeddings card vs cpu: max abs err {err:.3e} (atol 1e-3)")
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


def phase_step_time(cfg, state, sections):
    import torch

    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.train.step import make_train_step

    data = DeviceResidentData(ConcatSections.from_sections(sections[1:]), "cuda")
    batch = data.take(list(range(cfg.train.batch_size)))
    step = make_train_step("st", rot_impl=cfg.train.rot_impl)
    g = torch.Generator(device="cuda").manual_seed(1)
    draws = augment.sample_st_draws(g, cfg.train.batch_size, "cuda")
    for _ in range(2):
        step(state, batch, draws)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        loss = step(state, batch, draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite loss in the timed steps")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[step] her2st widths B={cfg.train.batch_size}: {ms:.1f} ms/step over {n} steps, "
        f"peak memory {peak:.1f} GiB, on {card_line()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    entries = phase_kernels()
    cfg, state, sections, launches = phase_train()
    for entry, layout in zip(entries, ("rows", "cols")):
        entry["launches"] = launches[layout]
    phase_reference(cfg, state, sections)
    phase_step_time(cfg, state, sections)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
