#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases, in
order; any failure exits non-zero and prints no result line:
  1. device: the card, its power limit, the TF32 flags;
  2. build: the port's CUDA kernel sources, compiled with nvcc for sm_90a,
     one nvcc each, in parallel;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the main path gives it, in each of its layouts, with its time, the
     plain version's time, a PyTorch yardstick and its bound: row_shift
     (bit-equal at random shifts and at the Paeth shears of drawn angles,
     timed by events and by CUDA-graph replays at both; the row shears in
     ``shift_rows16``, 16-byte chunks realigned from aligned source words;
     the column shear in ``shift_cols_band``, a band of 16 f32 or 32 bf16
     pixels' column staged in shared memory, 16-byte stores); the flash
     kernels, each block of 32 queries or keys one
     thread-block cluster that splits the walk, 3xTF32 tensor-core
     products, each with its plan (rows, split, CTAs): the forward, with
     and without residuals and deterministic, at the eval sweep's, the
     training and a ragged sequence length; the backward kernels (dK/dV,
     dQ) at the training length, the remainder batch's and a ragged one,
     the forward-and-backward pair timed against
     ``F.scaled_dot_product_attention``'s; and all three once at the JAX
     bench's whole-slide width (1, 16, 4,096, 64);
  4. patches: extract_patches (the patch gather; ``gather_rows16``, 16-byte
     chunks realigned from aligned slide words, where P * C is whole
     chunks, else ``gather_bytes``) bit-equal to its plain version in small
     cases (P 15/16/32/224, C 1/3/4, centers inside, on the border, far
     outside and at -2147483648, N = 0; a 50 x 83 slide, W * C no multiple
     of 16, with crop starts at every residue mod 16) and on a 20,000 x
     20,000 x 3 slide with 4,992 + 64 centers at P = 224, timed (events and
     graph replays) against indexing a pre-padded copy;
  5. train: ``train_fold`` at the her2st widths (densenet121, 224 px,
     spot_dim 785, pos_vocab 1024, 2 blocks of 8x64 heads, projection 256,
     batch 128) on synthetic sections made from a seed, one epoch of three
     full batches and a remainder; every loss finite, and every kernel of
     the path launched (row_shift three times per step: twice in its row
     layout through ``shift_rows16``, once in its column layout through
     ``shift_cols_band``);
  6. reference: the trained model on the card against the same weights on
     the CPU at a small batch (TF32 off for the comparison);
  7. step time: steady-state ms per train step;
  8. train-flash: ``train_fold`` at the same widths and on the same 450
     spots with ``attn_backend="flash"``: every softmax attention of the
     spot tower, forward and backward, in the flash kernels (forward with
     residuals, dK/dV and dQ, each launched head_layers x steps times);
     one step's spot-tower gradients against the "xla" model's from the
     same weights and batch; ms/step flash against xla;
  9. resume: the flash fold resumed from its checkpoint for one more
     epoch (start epoch, step count, finite losses, kernels launched);
 10. tenx: one ``augment_mode="tenx"`` step (the Visium augmentation, raw
     0-255 scale) on the card, its augmented images bit-equal to the
     CPU's for the same draws;
 11. eval: the trained fold's checkpoint (``load_checkpoint``) in a model
     with ``attn_backend="flash"``, ``compute_embeddings`` over the
     sections (every B=32 spot batch one attention sequence through the
     flash kernel, launched head_layers x ceil(N/32) times) and
     ``evaluate_fold_resident`` for every fold with host and device
     metrics (finite, agreeing); the flash tower's spot embeddings against
     the "xla" tower's, and the card's top-K indices against the CPU's on
     the same embeddings;
 12. serve: ``PredictionService.from_sections`` over a her2st-scale spot
     database (32 sections of 300-700 spots) through the flash kernel, one
     LOO fold over it (``evaluate_fold_resident``, the first section held
     out, random patches as its queries; host and device metrics agreeing,
     each timed), and ``make_server`` on a free local port answering
     /healthz, /predict (1, 37 and 256 patches), /embed and a malformed
     body (400); every answer equal to the service's own, with its latency;
 13. data: the real-dataset readers with standard-library I/O: a HER2ST
     tree (``synthetic.write_st_layout``, 4 sections of 300-700 spots x
     2,000 genes, two counts files gzipped) -> count frames -> a 785-gene
     panel (``select_panel``, saved and reloaded) -> ``load_her2st`` with a
     patch cache, one extract_patches launch per section, patches bit-equal
     to ``extract_patches_np``, then a cache hit with no launch ->
     ``train_fold`` at the her2st widths, ``compute_embeddings`` and
     ``evaluate_fold_resident`` (host and device metrics agreeing); a
     Visium tree (10x triplets, positions CSV, PPM ``image.tif``) ->
     ``build_visium_preprocessed`` -> ``load_visium`` (BGR patches) ->
     ``PosRemap`` -> one "tenx" step of the visium preset;
 14. cli: the port's command line (``mclstexp_tpu_torch.cli``) at the her2st
     preset's width on a synthetic HER2ST tree (4 sections of 300-700 spots x
     2,000 genes): ``hvg --select-panel`` (785 genes), ``hvg``, ``train``
     (fold 0, one epoch; row_shift 3 launches per step, extract_patches one
     per section on the cold patch cache), ``eval`` with host and then
     device metrics (agreeing within rtol 1e-4), ``predict`` (its metrics
     equal to eval's fold), ``export-torch`` and ``eval --torch-checkpoint``
     (averages bit-equal to eval's), ``eval --save-embeddings`` and
     ``--from-embeddings`` (equal), every load after train a cache hit with
     no launch; then ``serve`` as a process of its own on a free port,
     answering a POST of 37 patches as an in-process ``PredictionService``
     built from the same checkpoint; seconds per subcommand and the train
     ms/step from ``train_log.jsonl``;
 15. cli-baseline: the ``baseline`` subcommand on [cli]'s tree and panel,
     each command a process of its own, the four families at their
     reference widths (the CLI's defaults), fold 0, one epoch: HisToGene at
     112 px with ``--super-resolution`` (the held-out section's 56-px grid
     cut on the card: extract_patches launched once per section on the cold
     112-px cache and once for the grid; the npz's centers ``sr_grid``'s,
     its predictions finite), ``--load-checkpoint`` of its ``best_0`` (the
     same JSON and grid bit for bit, no training step); Hist2ST (zinb, 5
     bakes), its checkpoint rewritten in the reference's Lightning layout
     and scored by ``--torch-checkpoint`` (equal to the trained run);
     THItoGene; BLEEP (resnet50, 224 px, weighted top-50; the HEG PCC NaN
     only where a HEG is predicted constant); then HisToGene's checkpoint
     on the CPU in this process, its metrics and grid within 1e-3 of the
     card's; seconds per process; the grid's cut (events, bit-equal to
     ``extract_patches_np``) and ``sr_predict`` timed on the card;
 16. baselines: the flash kernels with segment ids (the padded slide's mask
     as int32, as the JAX package builds ``SegmentIds``) at the slide
     baselines' (1, 16, n, 64): n = 384, 768 and 4,096 with padded tails and
     one case of interleaved ids, each kernel within 2e-5 of its plain
     segment version, deterministic, padded rows the segment softmax's (not
     the key mask's), timed against the same kernel without ids and against
     ``F.scaled_dot_product_attention`` with the boolean same-segment mask;
     then HisToGene at the her2st flow's widths (dim 1024, 8 layers of 16 x
     64 heads, 112 px, 785 genes) through ``train_baseline_fold`` with
     ``attn_backend="flash"`` (one epoch of 3 slide steps; 8 segment
     launches of each kernel per step), flash against xla gradients on one
     padded slide, ``predict_slide`` on the card against the CPU,
     ``evaluate_baseline_fold``, ms per slide step; THItoGene (4 layers, ViT
     width 1,408, GAT) the same fold with "flash"; and one whole-slide
     HisToGene step at 3,969 spots (padded to 4,096), xla against flash;
 17. hist2st: Hist2ST at the reference widths (conv patchify, 2 mixers, dim
     1,024, 8 layers of 16 x 64 heads, 4 GraphSAGE blocks, the LSTM, 785
     genes, zinb 0.25, bake 5, lamb 0.5) on [baselines]' sections with
     "flash": fold 0 for one epoch (48 segment launches of each kernel per
     slide step: the slide and 5 bakes through 8 layers, gradients through
     all six), flash against xla gradients on one slide (TF32 off; where
     they part further than GRAD_RTOL, flash no farther than xla from a
     float64 evaluation), ``predict_slide``
     card against CPU (8 forward launches), ms per slide step at 768 rows
     (xla, flash, flash, xla) and one whole-slide step (4,096 rows) with
     peak memory;
 18. bleep: BLEEP (resnet50, 224 px, batch 128) on [train]'s sections:
     ``train_bleep_fold`` for fold 0 (the reference's 4 epochs),
     ``bleep_embeddings`` (the held-out
     section's card against CPU), ``evaluate_fold`` of fold 0 in the three
     retrieval modes, ms per step;
 19. bf16: ``dtype="bfloat16"`` (fp32 parameters, bf16 compute, fp32
     embeddings and loss). The bf16 flash kernels (built with the others in
     [build]; Hopper warpgroup kernels under ``bf16_plan``, checked first
     at the edges of their 64-row tiles, at d % 8 != 0 and on misaligned
     views) against their plain bf16 versions at (1, 8, n, 64), n = 32,
     128, 300, at d = 32 and 128, at the segment shapes (n = 384 and 768
     with padded tails, interleaved ids at 768) and at (1, 16, 4,096, 64)
     (events): bf16 outputs within 2**-7 of their largest magnitude +
     1e-5, l and m within 1e-5, the same bits on a second run; each timed
     beside the fp32 kernel on the same values, bf16 SDPA (with the
     boolean same-segment mask where ids are given) and its bound (bytes
     at 3.35 TB/s, operations at the 989 TFLOP/s bf16 rate). Then the
     her2st flagship in bf16 with "flash" through ``train_fold`` (every
     spot-tower attention in the bf16 kernels and none in the fp32 ones,
     row_shift's shears on bf16 images, the checkpoint saved), its
     embeddings and LOO fold 0, and ms/step and peak memory bf16 against
     fp32; ``cli train --dtype bfloat16`` and ``eval`` of its checkpoint on
     [cli]'s tree, each a process of its own; HisToGene in bf16 (a fold of
     3 slide steps with 8 bf16 segment launches of each kernel per step,
     ms per slide step and peak memory bf16 against fp32 at 768 rows and
     at the whole slide's 4,096), a THItoGene fold and a Hist2ST fold (48
     bf16 segment launches of each kernel per step, none in fp32) in bf16,
     and one BLEEP step in bf16.
The line before the last is a JSON object with one entry per kernel and
layout; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mclstexp_tpu_torch.profile_kernels import card_line, cuda_ms, graph_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM published fp32 rate outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} python={sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {card_line()}")
    log(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build():
    """Every kernel source at once: one nvcc process each, started together,
    so that the build takes the slowest source's time, not the sum."""
    from concurrent.futures import ThreadPoolExecutor

    from mclstexp_tpu_torch.ops import build, flash_attention, patches, row_shift

    def timed_build(source):
        t = time.perf_counter()
        return (*build.build_library(source), time.perf_counter() - t)

    sources = (row_shift.SOURCE, flash_attention.SOURCE, flash_attention.BWD_SOURCE,
               flash_attention.BF16_SOURCE, flash_attention.BF16_BWD_SOURCE, patches.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed_build, sources))
    for source, (path, out, seconds) in zip(sources, built):
        log(f"[build] {source} -> {path} in {seconds:.2f} s")
        for line in out.strip().splitlines():
            log(f"[build]   {line}")
    log(f"[build] done in {time.perf_counter() - t0:.2f} s "
        f"(the sources' own times sum to {sum(b[2] for b in built):.2f} s)")


def _padded(view, pad):
    """``view`` zero-padded by ``pad`` on both sides of W, in the view's layout."""
    import torch.nn.functional as F

    if view.is_contiguous():
        return F.pad(view, (0, 0, pad, pad))
    return F.pad(view.transpose(1, 2), (0, 0, 0, 0, pad, pad)).transpose(1, 2)


def _shift_bytes(view, k) -> int:
    """Bytes ``row_shift(view, k)`` must move: every output element written
    once, each input element that lands in the output read once (a line
    shifted by k keeps W - |k| of its W pixels, k clamped to +-W//2), and
    the shifts."""
    w = view.shape[2]
    kept = (w - k.long().clamp(-(w // 2), w // 2).abs()).sum().item()
    per_px = view.shape[3] * view.element_size()
    return view.numel() * view.element_size() + kept * per_px + k.numel() * 4


def _shear_launches(steps: int) -> dict:
    """``row_shift.kernel_launches`` after ``steps`` train steps: the Paeth
    rotation's two row shears and one column shear, each on its 16-byte
    kernel."""
    return {"shift_rows": 0, "shift_rows16": 2 * steps, "shift_cols": 0,
            "shift_cols_band": steps}


def _one_launch_kernel(view, k) -> str:
    """The kernel (``row_shift.kernel_launches`` key) one launch took."""
    from mclstexp_tpu_torch.ops.row_shift import row_shift

    before = dict(row_shift.kernel_launches)
    row_shift(view, k)
    (kernel,) = [n for n, c in row_shift.kernel_launches.items() if c != before[n]]
    return kernel


def phase_kernels() -> list:
    """row_shift against its plain version at the flagship shape, in both of
    its layouts: "rows" (contiguous image: the Paeth row shears, kernel
    ``shift_rows16``) and "cols" (the transposed view: the column shear,
    kernel ``shift_cols_band``), each of which the flagship must take, bit
    for bit at two shift inputs (``profile_kernels.shift_inputs``): uniform
    random shifts with the clamp edges, and the Paeth rotation's shears for
    128 drawn angles. One entry per layout, float32 (the main path's type):
    ``ms`` by events over eager launches at the random shifts (the measure
    earlier versions of this script reported), ``graph_ms`` and
    ``paeth_ms`` by CUDA-graph replays at the random and the Paeth shifts
    (``paeth_eager_ms`` by events), the kernel the launch took; bfloat16 is
    checked and timed too (under ``bf16``). The bound counts the bytes these
    shifts need (``_shift_bytes``: ``bound_ms`` at the random shifts,
    ``paeth_bound_ms`` at the Paeth ones), and ``full_read_bound_ms`` that
    of reading every input byte."""
    import torch

    from mclstexp_tpu_torch.ops.row_shift import row_shift_plain
    from mclstexp_tpu_torch.profile_kernels import FLAGSHIP, shift_inputs, time_row_shift

    b, h, w, c = FLAGSHIP
    g = torch.Generator(device="cuda").manual_seed(0)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = shift_inputs(g, dtype)
        for layout in ("rows", "cols"):
            view, k = cases[(layout, "random")]
            kernel = _one_launch_kernel(view, k)
            want = {"rows": "shift_rows16", "cols": "shift_cols_band"}[layout]
            if kernel != want or _one_launch_kernel(*cases[(layout, "paeth")]) != want:
                raise AssertionError(f"row_shift {layout} {dtype} at {FLAGSHIP} took {kernel}, "
                                     f"not {want}")
            rnd, paeth = time_row_shift(view, k), time_row_shift(*cases[(layout, "paeth")])
            plain_ms = cuda_ms(lambda: row_shift_plain(view, k), iters=20)
            bound_ms, paeth_bound_ms, full_ms = (
                nbytes / HBM_BYTES_PER_S * 1e3 for nbytes in (
                    _shift_bytes(view, k), _shift_bytes(*cases[(layout, "paeth")]),
                    2 * view.numel() * view.element_size() + k.numel() * 4))
            # Yardstick: one torch.gather over a zero-padded copy in the same
            # layout computes the same function (the pad is set-up, untimed).
            pad = w // 2
            xp = _padded(view, pad)
            src = (torch.arange(w, device="cuda") - k.long().clamp(-pad, pad)[..., None]
                   + pad)[..., None].expand(b, h, w, c)
            if not torch.equal(torch.gather(xp, 2, src), row_shift_plain(view, k)):
                raise AssertionError("gather yardstick computes another function")
            library_ms = cuda_ms(lambda: torch.gather(xp, 2, src))
            log(f"[kernels] row_shift {layout} {str(dtype)[6:]} {FLAGSHIP} kernel {kernel}: "
                f"bit-equal at random and Paeth shifts; random: eager {rnd['ms']:.4f} ms, graph "
                f"{rnd['graph_ms']:.4f} ms, bound {bound_ms:.4f} ms; Paeth: eager "
                f"{paeth['ms']:.4f} ms, graph {paeth['graph_ms']:.4f} ms, bound "
                f"{paeth_bound_ms:.4f} ms; plain {plain_ms:.4f} ms, torch.gather "
                f"{library_ms:.4f} ms; graph {bound_ms / rnd['graph_ms']:.1%} / "
                f"{paeth_bound_ms / paeth['graph_ms']:.1%} of bound (random / Paeth); reading "
                f"every input byte: bound {full_ms:.4f} ms, {full_ms / rnd['graph_ms']:.1%} / "
                f"{full_ms / paeth['graph_ms']:.1%}")
            numbers = {"ms": rnd["ms"], "graph_ms": rnd["graph_ms"],
                       "paeth_ms": paeth["graph_ms"], "paeth_eager_ms": paeth["ms"],
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "paeth_bound_ms": paeth_bound_ms, "full_read_bound_ms": full_ms,
                       "library_ms": library_ms, "kernel": kernel}
            if dtype == torch.float32:
                entries[layout] = {
                    "name": f"row_shift[{layout}]", "route": "cuda",
                    "source": "mclstexp_tpu_torch/csrc/row_shift.cu",
                    "replaces": "mclstexp_tpu/ops/pallas_shift.py:36",
                    "bound_by": "bytes", "max_abs_err": 0.0, **numbers}
            else:
                entries[layout]["bf16"] = numbers
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

    _reset_counts()
    logger = MetricLogger(echo=True)
    t0 = time.perf_counter()
    state = train_fold(cfg, sections, fold=0, logger=logger, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernels = dict(row_shift.kernel_launches)

    losses = [r["loss"] for r in logger.records if "loss" in r]
    if state.step != steps or len(losses) != steps:
        raise AssertionError(f"expected {steps} steps, took {state.step} ({len(losses)} logged)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if row_shift.launches != 3 * steps or kernels != _shear_launches(steps):
        raise AssertionError(f"row_shift launched {row_shift.launches} times (kernels "
                             f"{kernels}) in {steps} steps; the Paeth rotation takes 3 per "
                             "step, two row shears (shift_rows16) and one column shear "
                             "(shift_cols_band)")
    log(f"[train] train_fold: {steps} steps ({n_train} spots, remainder "
        f"{n_train % cfg.train.batch_size}) in {seconds:.1f} s incl. set-up; "
        f"running losses {losses}; row_shift launches {row_shift.launches} {kernels}")
    return cfg, state, sections, kernels


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


def _step_batch(cfg, sections):
    """One full training batch on the card and "st" draws for it."""
    import torch

    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData
    from mclstexp_tpu_torch.ops import augment

    data = DeviceResidentData(ConcatSections.from_sections(sections[1:]), "cuda")
    batch = data.take(list(range(cfg.train.batch_size)))
    g = torch.Generator(device="cuda").manual_seed(1)
    return batch, augment.sample_st_draws(g, cfg.train.batch_size, "cuda")


def _step_ms(cfg, state, batch, draws, n: int = 5) -> float:
    """Steady-state host ms per "st" train step (after two warm-up steps),
    each run ending in a synchronize."""
    import torch

    from mclstexp_tpu_torch.train.step import make_train_step

    step = make_train_step("st", rot_impl=cfg.train.rot_impl)
    for _ in range(2):
        step(state, batch, draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss = step(state, batch, draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite loss in the timed steps")
    return ms


def phase_step_time(cfg, state, sections):
    import torch

    batch, draws = _step_batch(cfg, sections)
    torch.cuda.reset_peak_memory_stats()
    ms = _step_ms(cfg, state, batch, draws)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[step] her2st widths B={cfg.train.batch_size}: {ms:.1f} ms/step over 5 steps, "
        f"peak memory {peak:.1f} GiB, on {card_line()}")


FLASH_SHAPES = ((1, 8, 32, 64), (1, 8, 128, 64), (1, 8, 300, 64))  # eval sweep, train, ragged
FLASH_ATOL = 2e-5


def _flash_fwd_bound(shape):
    """(bound ms, bound_by, bytes, flops) of the forward at ``shape``: q, k,
    v read and out written once (4*b*h*n*d floats), two products of
    2*b*h*n^2*d flops; the larger of the bytes at 3.35 TB/s and the flops
    at 67 TFLOP/s."""
    b, h, n, d = shape
    nbytes = 4 * b * h * n * d * 4
    flops = 4 * b * h * n * n * d
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops


def _flash_fwd_err(q, k, v, scale):
    """The forward kernel with residuals against flash_forward_plain: the
    largest of out's and m's absolute errors and l's relative error."""
    import torch

    from mclstexp_tpu_torch.ops.flash_attention import flash_forward, flash_forward_plain

    got, want = flash_forward(q, k, v, scale, residuals=True), flash_forward_plain(q, k, v, scale)
    torch.cuda.synchronize()
    return max(float((got[0] - want[0]).abs().max()),
               float(((got[1] - want[1]) / want[1]).abs().max()),
               float((got[2] - want[2]).abs().max()))


def phase_flash_kernels() -> dict:
    """flash_attention against attention_plain in fp32 at the eval sweep's
    shape (b, h, n, d) = (1, 8, 32, 64), the training shape n=128 and a
    length that is no multiple of the 32-row tile, read in place from a
    (b, n, 3, h, d) qkv buffer as the spot tower gives it. atol 2e-5: both
    are fp32, with the sums in another order, the kernel's online softmax
    rescaling and its 3xTF32 products. The forward with residuals (what
    training runs) is held to ``flash_forward_plain``: out and m to atol
    2e-5, l relative; both forms give the same bits on a second run. Each
    line names the plan (``cluster_plan``: query rows per block, split of
    the key walk, CTAs); the training shape must run at least 128 CTAs.
    Times are device times of CUDA-graph replays; the yardstick is
    F.scaled_dot_product_attention on the same views. The entry carries the
    eval shape's numbers, each shape's numbers and plan under ``shapes``,
    and the largest error."""
    import torch
    import torch.nn.functional as F

    from mclstexp_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(0)
    entry, shapes = None, {}
    for b, h, n, d in FLASH_SHAPES:
        shape = (b, h, n, d)
        rows, split, ctas = plan = fa.cluster_plan(*shape)
        if shape == FLASH_SHAPES[1] and ctas < 128:
            raise AssertionError(f"the training shape's forward plan {plan} runs {ctas} < 128 "
                                 "CTAs")
        qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda")
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scale = d**-0.5
        got, want = fa.flash_attention(q, k, v, scale), fa.attention_plain(q, k, v, scale)
        sdpa = F.scaled_dot_product_attention(q, k, v, scale=scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        res_err = _flash_fwd_err(q, k, v, scale)
        if not res_err <= FLASH_ATOL:
            raise AssertionError(f"flash forward with residuals {shape}: out, l (relative) or m "
                                 f"off by {res_err:.3e} > {FLASH_ATOL}")
        again = (fa.flash_attention(q, k, v, scale), fa.flash_forward(q, k, v, scale, True),
                 fa.flash_forward(q, k, v, scale, True))
        if not (torch.equal(again[0], got) and all(
                torch.equal(x, y) for x, y in zip(again[1], again[2]))):
            raise AssertionError(f"flash forward {shape}: two runs differ")
        residuals_ms = graph_ms(lambda: fa.flash_forward(q, k, v, scale, residuals=True))
        sdpa_err = float((sdpa - want).abs().max())
        if not err <= FLASH_ATOL:
            raise AssertionError(f"flash_attention {shape}: max abs err {err:.3e} "
                                 f"> {FLASH_ATOL}")
        if not sdpa_err <= 1e-4:
            raise AssertionError(f"the SDPA yardstick computes another function ({sdpa_err})")
        ms = graph_ms(lambda: fa.flash_attention(q, k, v, scale))
        plain_ms = graph_ms(lambda: fa.attention_plain(q, k, v, scale))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        call_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, scale))
        bound_ms, bound_by, nbytes, flops = _flash_fwd_bound(shape)
        log(f"[kernels] flash_attention fp32 {shape} plan rows={rows} split={split} "
            f"ctas={ctas}: max abs err {err:.3e} (atol {FLASH_ATOL}); kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, SDPA {library_ms:.5f} ms (err {sdpa_err:.1e}), kernel / SDPA "
            f"{ms / library_ms:.3f}, bound {bound_ms:.6f} ms by {bound_by} ({nbytes / 1e6:.2f} "
            f"MB, {flops / 1e6:.1f} MFLOP), {bound_ms / ms:.1%} of bound; eager call incl. "
            f"launch {call_ms:.5f} ms; with residuals (l, m) {residuals_ms:.5f} ms, out/l/m "
            f"within {res_err:.1e} of the plain version; deterministic")
        shapes[str(shape)] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                              "residuals_ms": residuals_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "max_abs_err": max(err, res_err),
                              "plan": {"rows": rows, "split": split, "ctas": ctas}}
        if entry is None:
            entry = {"name": "flash_attention[fwd]", "route": "cuda",
                     "source": "mclstexp_tpu_torch/csrc/flash_attention.cu",
                     "replaces": "mclstexp_tpu/core/layers.py:201",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms, "max_abs_err": err}
        entry["max_abs_err"] = max(entry["max_abs_err"], err, res_err)
    entry["shapes"] = shapes
    return entry


BWD_SHAPES = ((1, 8, 128, 64), (1, 8, 66, 64), (1, 8, 300, 64))  # train, remainder, ragged
# The TPU kernels the backward kernels replace (jax 0.9.0's
# jax/experimental/pallas/ops/tpu/flash_attention.py: the pallas_call lines).
BWD_REPLACES = {
    "bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
    "bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
}


def _bwd_case(g, shape):
    """The backward kernels' arguments at ``shape`` (q, k, v as the views of
    a (b, n, 3, h, d) qkv buffer, dout, the kernel forward's l and m, di =
    rowsum(out * dout), scale) and the two pairs to time on them: forward
    with residuals + dK/dV + dQ, and ``torch.autograd.grad`` of
    F.scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from mclstexp_tpu_torch.ops import flash_attention as fa

    b, h, n, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda")
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, n, d), generator=g, device="cuda")
    scale = d**-0.5
    out, l, m = fa.flash_forward(q, k, v, scale, residuals=True)
    di = (out * do).sum(-1).contiguous()
    qkv_g = qkv.clone().requires_grad_()

    def library_pair():
        # The views are taken inside, so that under graph capture every op
        # that autograd replays backward ran on the capturing stream.
        sq, sk, sv = (qkv_g[:, :, i].transpose(1, 2) for i in range(3))
        return torch.autograd.grad(
            (F.scaled_dot_product_attention(sq, sk, sv, scale=scale) * do).sum(), qkv_g)[0]

    def pair():
        o, ll, mm = fa.flash_forward(q, k, v, scale, residuals=True)
        dd = (o * do).sum(-1).contiguous()
        fa.flash_bwd_dkv(q, k, v, do, ll, mm, dd, scale)
        fa.flash_bwd_dq(q, k, v, do, ll, mm, dd, scale)

    return (q, k, v, do, l, m, di, scale), pair, library_pair


def _bwd_kernels(shape):
    """(name, kernel, plain version, bound ms, bound_by, bytes, flops) of
    dK/dV and dQ at ``shape``: dK/dV reads q, k, v, dout, l, m, di and
    writes dk, dv (8*b*h*n^2*d flops), dQ writes dq (6*b*h*n^2*d); the bound
    is the larger of the bytes at 3.35 TB/s and the flops at 67 TFLOP/s."""
    from mclstexp_tpu_torch.ops import flash_attention as fa

    b, h, n, d = shape
    out = []
    for name, kernel, plain, n_out, per_flop in (
            ("bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
            ("bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6)):
        nbytes = (4 + n_out) * b * h * n * d * 4 + 3 * b * h * n * 4
        flops = per_flop * b * h * n * n * d
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        out.append((name, kernel, plain, max(bytes_ms, ops_ms),
                    "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops))
    return out


def _max_err(got, want) -> float:
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    return max(float((a - b).abs().max()) for a, b in zip(as_tuple(got), as_tuple(want)))


def phase_flash_bwd_kernels() -> list:
    """The flash backward kernels, dK/dV and dQ, against their plain
    versions in fp32 at the training shape (1, 8, 128, 64), the remainder
    batch's n=66 and a ragged n=300, on the views of a (b, n, 3, h, d) qkv
    buffer, fed the kernel forward's l and m and di = rowsum(out * dout).
    atol 2e-5, as for the forward (fp32, sums in another order). Device
    times of CUDA-graph replays; bounds as ``_bwd_kernels`` says. No one
    PyTorch call computes dK/dV or dQ alone, so ``library_ms`` is null; the
    yardstick is the pair: forward with residuals + dK/dV + dQ
    (``pair_ms``) against ``torch.autograd.grad`` of
    F.scaled_dot_product_attention (``library_pair_ms``) on the same views.
    Each line names the kernels' plan (``cluster_plan``: tile rows, split of the
    walk, CTAs); the training shape must run at least 128 CTAs. The entries
    carry the training shape's numbers, plan and the largest error."""
    import torch

    from mclstexp_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)
    entries = {}
    for shape in BWD_SHAPES:
        rows, split, ctas = plan = fa.cluster_plan(*shape)
        if shape == BWD_SHAPES[0] and ctas < 128:
            raise AssertionError(f"the training shape's backward plan {plan} runs {ctas} < 128 "
                                 "CTAs")
        args, pair, library_pair = _bwd_case(g, shape)
        dk, dv = fa.flash_bwd_dkv(*args)
        dq = fa.flash_bwd_dq(*args)
        sdpa_grads = library_pair()
        torch.cuda.synchronize()
        sdpa_err = max(float((a - sdpa_grads[:, :, i].transpose(1, 2)).abs().max())
                       for i, a in enumerate((dq, dk, dv)))
        if not sdpa_err <= 1e-4:
            raise AssertionError(f"the SDPA pair computes other gradients ({sdpa_err})")
        pair_ms, library_pair_ms = graph_ms(pair), graph_ms(library_pair)
        for name, kernel, plain, bound_ms, bound_by, nbytes, flops in _bwd_kernels(shape):
            err = _max_err((dk, dv) if name == "bwd_dkv" else dq, plain(*args))
            if not err <= FLASH_ATOL:
                raise AssertionError(f"flash_attention[{name}] {shape}: max abs err {err:.3e} "
                                     f"> {FLASH_ATOL}")
            ms = graph_ms(lambda: kernel(*args))
            plain_ms = graph_ms(lambda: plain(*args))
            log(f"[kernels] flash_attention[{name}] fp32 {shape} plan rows={rows} "
                f"split={split} ctas={ctas}: max abs err {err:.3e} (atol {FLASH_ATOL}); kernel "
                f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms by {bound_by} "
                f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP), {bound_ms / ms:.1%} of bound")
            if name not in entries:
                entries[name] = {
                    "name": f"flash_attention[{name}]", "route": "cuda",
                    "source": "mclstexp_tpu_torch/csrc/flash_attention_bwd.cu",
                    "replaces": BWD_REPLACES[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "max_abs_err": err, "plan": {"rows": rows, "split": split, "ctas": ctas},
                    "pair_ms": pair_ms, "library_pair_ms": library_pair_ms}
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
        log(f"[kernels] flash forward with residuals + dK/dV + dQ {shape}: {pair_ms:.5f} ms; "
            f"SDPA forward + backward (torch.autograd.grad) {library_pair_ms:.5f} ms; pair / "
            f"SDPA {pair_ms / library_pair_ms:.3f} (gradients within {sdpa_err:.1e} of the "
            f"kernels')")
    return [entries["bwd_dkv"], entries["bwd_dq"]]


BWD_LONG = (1, 16, 4096, 64)  # the JAX bench's whole-slide attention (bench.py:670-714)


def phase_flash_bwd_long(fwd_entry, entries) -> None:
    """The forward alone, dK/dV and dQ once at (1, 16, 4,096, 64) fp32
    against their plain versions (atol 2e-5; the forward's l relative),
    timed by CUDA events over eager launches (a graph of plain calls at
    this size would hold GBs in its pool): the forward against SDPA's
    forward, the pair against SDPA's forward + backward. Bounds as in
    [kernels]: the flops at the fp32 rate (69 / 137 / 103 GFLOP). Adds a
    ``long`` record to each entry."""
    import torch
    import torch.nn.functional as F

    from mclstexp_tpu_torch.ops import flash_attention as fa

    rows, split, ctas = fa.cluster_plan(*BWD_LONG)
    args, pair, library_pair = _bwd_case(torch.Generator(device="cuda").manual_seed(2), BWD_LONG)
    q, k, v, scale = *args[:3], args[7]
    err = _flash_fwd_err(q, k, v, scale)
    if not err <= FLASH_ATOL:
        raise AssertionError(f"flash forward {BWD_LONG}: out, l (relative) or m off by "
                             f"{err:.3e} > {FLASH_ATOL}")
    ms = cuda_ms(lambda: fa.flash_forward(q, k, v, scale), iters=10, warmup=2)
    residuals_ms = cuda_ms(lambda: fa.flash_forward(q, k, v, scale, residuals=True), iters=10,
                           warmup=2)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters=10,
                         warmup=2)
    plain_ms = cuda_ms(lambda: fa.flash_forward_plain(q, k, v, scale), iters=3, warmup=1)
    bound_ms, bound_by, _, flops = _flash_fwd_bound(BWD_LONG)
    log(f"[kernels] flash_attention fp32 {BWD_LONG} plan rows={rows} split={split} ctas={ctas}: "
        f"out/l/m within {err:.3e} of the plain version (atol {FLASH_ATOL}); kernel {ms:.4f} ms, "
        f"with residuals {residuals_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA forward "
        f"{library_ms:.4f} ms, kernel / SDPA {ms / library_ms:.3f}, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops / 1e9:.1f} GFLOP), {bound_ms / ms:.1%} of bound "
        f"({flops / ms / 1e9:.1f} TFLOP/s fp32 work)")
    fwd_entry["max_abs_err"] = max(fwd_entry["max_abs_err"], err)
    fwd_entry["long"] = {"shape": list(BWD_LONG), "ms": ms, "residuals_ms": residuals_ms,
                         "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": err,
                         "plan": {"rows": rows, "split": split, "ctas": ctas}}
    pair_ms = cuda_ms(pair, iters=10, warmup=2)
    library_pair_ms = cuda_ms(library_pair, iters=10, warmup=2)
    for entry, (name, kernel, plain, bound_ms, bound_by, _, flops) in zip(
            entries, _bwd_kernels(BWD_LONG)):
        err = _max_err(kernel(*args), plain(*args))
        if not err <= FLASH_ATOL:
            raise AssertionError(f"flash_attention[{name}] {BWD_LONG}: max abs err {err:.3e} > "
                                 f"{FLASH_ATOL}")
        ms = cuda_ms(lambda: kernel(*args), iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        log(f"[kernels] flash_attention[{name}] fp32 {BWD_LONG} plan rows={rows} split={split} "
            f"ctas={ctas}: max abs err {err:.3e} (atol {FLASH_ATOL}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP), "
            f"{bound_ms / ms:.1%} of bound ({flops / ms / 1e9:.1f} TFLOP/s fp32 work)")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["long"] = {"shape": list(BWD_LONG), "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                         "plan": {"rows": rows, "split": split, "ctas": ctas},
                         "pair_ms": pair_ms, "library_pair_ms": library_pair_ms}
    log(f"[kernels] flash forward with residuals + dK/dV + dQ {BWD_LONG}: {pair_ms:.4f} ms; "
        f"SDPA forward + backward {library_pair_ms:.4f} ms; pair / SDPA "
        f"{pair_ms / library_pair_ms:.3f} (events over eager launches), on {card_line()}")
    del args, pair, library_pair
    torch.cuda.empty_cache()


I32_MIN = -2**31
PATCH_SMALL_CENTERS = ((10, 12), (40, 30), (0, 0), (79, 59), (80, 60), (-5, 30), (-200, 5),
                       (500, 500), (40, -90), (I32_MIN, I32_MIN), (I32_MIN, 20), (2**31 - 1, 7))
PATCH_SIZES = (15, 16, 32, 224)


def _residue_centers(w: int, h: int, patch: int):
    """Centers whose crop starts x0 = x - P//2 run over every residue mod 16,
    inside the slide and across both of its side edges, on rows inside,
    across the top and bottom edges and outside."""
    import torch

    r = patch // 2
    xs = torch.arange(r - 20, r + w + 4)  # x0 from -20 to w + 3
    ys = torch.tensor([r, h // 2, h - 1, -r + 3, h + r - 3, -5 * h])
    return torch.stack([xs, ys[xs % len(ys)]], 1).cuda()


def phase_patches() -> dict:
    """extract_patches (csrc/extract_patches.cu) against extract_patches_plain,
    bit for bit: small cases (P 15, 16, 32, 224; C 1, 3, 4; centers inside,
    on the border, far outside, at -2147483648; N = 0); a 50 x 83 slide,
    whose rows of W * C bytes are no multiple of 16 (83, 249 and 332 at C
    1, 3, 4), with crop starts at every residue mod 16 (the 16-byte path's
    realignment, and the byte path at odd P * C); then the full-size case,
    timed (``profile_kernels.time_patches``): a 20,000 x 20,000 x 3 uint8
    slide (1.2 GB, a Visium full-resolution image) made on the card from a
    seed, 4,992 grid centers and 64 at and past the border, P = 224, by
    events over eager launches (``ms``) and CUDA-graph replays
    (``graph_ms``). The yardstick (library_ms) is one advanced-indexing call
    over a copy of the slide padded by P, with the start indices clamped into
    it; the pad and the index tensors are made before the timed window.
    Bound: the bytes of the crop (each output byte written once, each
    in-slide source byte read once) at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F

    from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_plain, patch_plan
    from mclstexp_tpu_torch.profile_kernels import (
        PATCH, VISIUM_SIDE, patch_bytes, patch_input, time_patches)

    g = torch.Generator(device="cuda").manual_seed(4)
    small = torch.tensor(PATCH_SMALL_CENTERS, device="cuda")
    kernels = set()
    for c in (1, 3, 4):
        slide = torch.randint(0, 256, (60, 80, c), generator=g, device="cuda",
                              dtype=torch.uint8)
        odd = torch.randint(0, 256, (50, 83, c), generator=g, device="cuda", dtype=torch.uint8)
        for p in PATCH_SIZES:
            for s, centers in ((slide, small), (odd, _residue_centers(83, 50, p))):
                got = extract_patches(s, centers, p)
                if not torch.equal(got, extract_patches_plain(s, centers, p)):
                    raise AssertionError(f"extract_patches {tuple(s.shape)} P={p} differs from "
                                         "its plain version")
            kernels.add(patch_plan(len(small), p, c).kernel)
        if extract_patches(slide, small[:0], 16).shape != (0, 16, 16, c):
            raise AssertionError("extract_patches with N = 0")
    if kernels != {"gather_rows16", "gather_bytes"}:
        raise AssertionError(f"the small cases ran the kernels {kernels}, not both paths")
    log(f"[patches] small cases: bit-equal at P {PATCH_SIZES}, C 1/3/4, "
        f"{len(PATCH_SMALL_CENTERS)} centers (inside, border, far outside, -2147483648) on a "
        f"60 x 80 slide, and crop starts at every residue mod 16 on a 50 x 83 slide (W * C "
        f"no multiple of 16); paths {sorted(kernels)}; N = 0 ok")

    side, p = VISIUM_SIDE, PATCH
    slide, host_centers, centers = patch_input(g)
    plan = patch_plan(len(host_centers), p, 3)
    times = time_patches(slide, centers)
    r = p // 2
    padded = F.pad(slide, (0, 0, p, p, p, p))
    offs = torch.arange(p, device="cuda")
    rows = ((centers[:, 1] - r + p).clamp(0, side + p)[:, None] + offs)[:, :, None]
    cols = ((centers[:, 0] - r + p).clamp(0, side + p)[:, None] + offs)[:, None, :]
    if not torch.equal(padded[rows, cols], extract_patches(slide, centers, p)):
        raise AssertionError("the indexing yardstick computes another function")
    plain_ms = cuda_ms(lambda: extract_patches_plain(slide, centers, p), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: padded[rows, cols], iters=10, warmup=2)
    nbytes = patch_bytes(host_centers, side, p, 3)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[patches] {side} x {side} x 3 slide ({slide.numel() / 1e9:.2f} GB), "
        f"{len(host_centers)} centers, P={p}, plan {plan}: bit-equal; kernel {times['ms']:.4f} "
        f"ms (graph {times['graph_ms']:.4f} ms), plain {plain_ms:.4f} ms, indexing a pre-padded "
        f"copy {library_ms:.4f} ms (pad and indices outside the timed window), bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB by bytes), {bound_ms / times['ms']:.1%} of "
        f"bound, on {card_line()}")
    del slide, padded
    torch.cuda.empty_cache()
    return {"name": "extract_patches", "route": "cuda",
            "source": "mclstexp_tpu_torch/csrc/extract_patches.cu",
            "replaces": "mclstexp_tpu/ops/pallas_patches.py:84",
            "also_replaces": "mclstexp_tpu/ops/pallas_patches.py:166",
            "ms": times["ms"], "graph_ms": times["graph_ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
            "max_abs_err": 0.0, "kernel": plan.kernel}


def _flash_counts(segments: bool = False, prefix: str = "") -> tuple:
    """The (forward, dK/dV, dQ) launch counts of the fp32 kernels, or with
    ``prefix`` "bf16_" of the bf16 ones."""
    from mclstexp_tpu_torch.ops import flash_attention as fa

    name = prefix + ("segment_launches" if segments else "launches")
    return tuple(getattr(w, name) for w in (fa.flash_attention, fa.flash_bwd_dkv,
                                            fa.flash_bwd_dq))


def _reset_counts() -> None:
    from mclstexp_tpu_torch.ops import flash_attention as fa
    from mclstexp_tpu_torch.ops.row_shift import row_shift

    for w in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq):
        w.launches = w.segment_launches = w.bf16_launches = w.bf16_segment_launches = 0
    row_shift.launches = 0
    row_shift.kernel_launches = dict.fromkeys(row_shift.kernel_launches, 0)


def _train_flash_fold(cfg, sections, resume: bool):
    """train_fold with the counts set to 0 just before it and read just
    after: (state, losses, resume records, (fwd, dkv, dq) launches,
    row_shift launches by layout)."""
    import torch

    from mclstexp_tpu_torch.ops.row_shift import row_shift
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(echo=True)
    _reset_counts()
    state = train_fold(cfg, sections, fold=0, logger=logger, device="cuda", resume=resume)
    torch.cuda.synchronize()
    counts, shifts = _flash_counts(), dict(row_shift.kernel_launches)
    losses = [r["loss"] for r in logger.records if "loss" in r]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite or missing training losses: {losses}")
    resumed = [r for r in logger.records if r.get("event") == "resume"]
    return state, losses, resumed, counts, shifts


GRAD_RTOL = 1e-4  # of each gradient tensor's largest magnitude


def _spot_grads(model, img_emb, batch):
    """The spot tower's parameter gradients of the InfoNCE loss against
    fixed image embeddings (train mode; the image tower is left out so that
    only the attention backend differs between two models)."""
    from mclstexp_tpu_torch.core.losses import symmetric_infonce

    model.train()
    model.zero_grad(set_to_none=True)
    spot = model.encode_spots(batch["expression"], batch["position"])
    symmetric_infonce(spot, img_emb, model.config.temperature).backward()
    return {name: p.grad.clone() for name, p in model.named_parameters() if p.grad is not None}


def phase_train_flash(cfg, sections, xla_state):
    """train_fold at the her2st widths with attn_backend="flash": every
    softmax attention of the spot tower, forward and backward, in the flash
    kernels; then the spot tower's gradients and the step time against the
    "xla" model."""
    import dataclasses

    import torch

    from mclstexp_tpu_torch.data.pipeline import num_train_steps
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.ops import augment

    root = os.path.dirname(os.path.abspath(__file__))
    fcfg = cfg.replace(
        model=dataclasses.replace(cfg.model, attn_backend="flash"),
        train=dataclasses.replace(cfg.train, checkpoint_dir=os.path.join(
            root, "build", "chip_smoke", "model_result_flash")))
    m = fcfg.model
    steps = num_train_steps(sum(s.num_spots for s in sections[1:]), cfg.train.batch_size)
    t0 = time.perf_counter()
    state, losses, _, counts, shifts = _train_flash_fold(fcfg, sections, resume=False)
    seconds = time.perf_counter() - t0
    want = m.head_layers * steps
    if state.step != steps or len(losses) != steps:
        raise AssertionError(f"expected {steps} steps, took {state.step}")
    if counts != (want, want, want):
        raise AssertionError(f"flash forward, dK/dV, dQ launched {counts} times in {steps} "
                             f"steps; head_layers x steps = {want} each")
    if shifts != _shear_launches(steps):
        raise AssertionError(f"row_shift launched {shifts} in {steps} steps")
    log(f"[train-flash] train_fold attn_backend='flash': {steps} steps in {seconds:.1f} s "
        f"incl. set-up; running losses {losses}; launches forward/dK-dV/dQ {counts} "
        f"(head_layers x steps = {want}); row_shift {shifts}")

    # One step's spot-tower gradients, flash against xla, same weights and batch.
    batch, draws = _step_batch(cfg, sections)
    xla_model = MclSTExp(dataclasses.replace(m, attn_backend="xla"), device="cuda")
    xla_model.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        images = augment.train_augment_inline(batch["image_u8"], draws)
        img_emb = state.model.eval().encode_image(images)
    got, want_grads = _spot_grads(state.model, img_emb, batch), _spot_grads(xla_model, img_emb,
                                                                            batch)
    if set(got) != set(want_grads) or not any("spot_encoder" in k for k in got):
        raise AssertionError(f"spot-tower gradients differ in their parameters: {sorted(got)}")
    worst, worst_name = 0.0, None
    for name, g in got.items():
        scale = float(want_grads[name].abs().max())
        err = float((g - want_grads[name]).abs().max()) / max(scale, 1e-30)
        if not (torch.isfinite(g).all() and err <= GRAD_RTOL):
            raise AssertionError(f"{name}: flash vs xla gradient off by {err:.3e} of its "
                                 f"largest magnitude {scale:.3e} (allowed {GRAD_RTOL})")
        if err >= worst:
            worst, worst_name = err, name
    log(f"[train-flash] spot-tower gradients, flash vs xla, {len(got)} tensors: largest "
        f"error {worst:.3e} of the tensor's largest magnitude ({worst_name}; allowed "
        f"{GRAD_RTOL})")

    times = {"xla": [], "flash": []}
    for name in ("xla", "flash", "flash", "xla"):
        times[name].append(_step_ms(cfg, xla_state if name == "xla" else state, batch, draws))
    log(f"[train-flash] ms/step at B={cfg.train.batch_size} (xla, flash, flash, xla, 5 steps "
        f"each): xla {times['xla']}, flash {times['flash']} on {card_line()}")
    return fcfg, steps, counts


def phase_resume(fcfg, sections, steps):
    """The flash fold resumed from its final checkpoint for one more epoch."""
    import dataclasses

    rcfg = fcfg.replace(train=dataclasses.replace(fcfg.train, max_epochs=2))
    state, losses, resumed, counts, _ = _train_flash_fold(rcfg, sections, resume=True)
    want = fcfg.model.head_layers * steps
    if [r["epoch"] for r in resumed] != [1]:
        raise AssertionError(f"resume records {resumed}; expected one at epoch 1")
    if state.step != 2 * steps or len(losses) != steps or counts != (want, want, want):
        raise AssertionError(f"resumed fold: step {state.step} (want {2 * steps}), "
                             f"{len(losses)} losses, launches {counts}")
    log(f"[resume] from step {steps}: start epoch 1, {len(losses)} more steps to step "
        f"{state.step}, losses {losses}, launches forward/dK-dV/dQ {counts}")


def phase_tenx(cfg, sections, state):
    """One augment_mode="tenx" step (raw scale) on the card; its augmented
    images against the CPU's for the same draws, bit for bit."""
    import torch

    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.train.step import make_train_step

    data = DeviceResidentData(ConcatSections.from_sections(sections[1:]), "cuda")
    batch = data.take(list(range(cfg.train.batch_size)))
    g = torch.Generator(device="cuda")
    draws = augment.sample_tenx_draws(augment.reseed(g, 0, 0, 0), cfg.train.batch_size, "cuda")
    tenx, seen = augment.tenx_augment, []

    def record(*args, **kw):
        seen.append(tenx(*args, **kw))
        return seen[-1]

    augment.tenx_augment = record
    try:
        loss = float(make_train_step("tenx", tenx_raw_scale=True)(state, batch, draws))
    finally:
        augment.tenx_augment = tenx
    cpu_draws = augment.TenxDraws(draws.hflip.cpu(), draws.vflip.cpu(), draws.rot.cpu())
    want = augment.tenx_augment(batch["image_u8"].cpu(), cpu_draws, raw_scale=True)
    if len(seen) != 1 or not torch.equal(seen[0].cpu(), want):
        raise AssertionError("the card's tenx images differ from the CPU's")
    if not math.isfinite(loss):
        raise AssertionError(f"tenx step loss {loss}")
    turns = torch.bincount(draws.rot.cpu(), minlength=4).tolist()
    log(f"[tenx] one raw-scale step at B={cfg.train.batch_size}: loss {loss:.4f}; images "
        f"bit-equal to the CPU's (max {float(want.max()):.0f}; flips h/v "
        f"{int(draws.hflip.sum())}/{int(draws.vflip.sum())}, rotation draws {turns})")


def phase_eval(cfg, sections):
    """The retrieval path at the her2st widths with attn_backend="flash":
    the eval sweep and the LOO folds over the trained weights."""
    import dataclasses

    import numpy as np
    import torch

    from mclstexp_tpu_torch.infer import embed, evaluate
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.ops import retrieval
    from mclstexp_tpu_torch.ops.flash_attention import flash_attention
    from mclstexp_tpu_torch.train import checkpoint

    m, ev = cfg.model, cfg.eval
    # [train]'s final checkpoint (the [step] phase trained the state further
    # since): once into the flash model, once into an "xla" one to hold it to
    saved = checkpoint.fold_checkpoint_dir(cfg.train.checkpoint_dir, cfg.data.dataset,
                                           sections[0].name, 0)
    model = MclSTExp(dataclasses.replace(m, attn_backend="flash"), device="cuda")
    xla_model = MclSTExp(dataclasses.replace(m, attn_backend="xla"), device="cuda")
    step = checkpoint.load_checkpoint(saved, model)
    checkpoint.load_checkpoint(saved, xla_model)
    log(f"[eval] loaded {saved} (step {step}) into a model with attn_backend='flash'")
    n = sum(s.num_spots for s in sections)
    prepared = embed.prepare_eval_arrays(sections, device="cuda")

    flash_attention.launches = 0
    img, spot = embed.compute_embeddings(model, sections, ev.batch_size, prepared=prepared,
                                         as_device=True, device="cuda")
    torch.cuda.synchronize()
    launches = flash_attention.launches
    want = m.head_layers * -(-n // ev.batch_size)
    if launches != want:
        raise AssertionError(f"flash_attention launched {launches} times in the sweep of {n} "
                             f"spots; head_layers x ceil(N/{ev.batch_size}) = {want}")
    for name, e in (("image", img), ("spot", spot)):
        if e.shape != (n, m.projection_dim) or not torch.isfinite(e).all():
            raise AssertionError(f"{name} embeddings: shape {tuple(e.shape)} or non-finite")
    rates = {}
    for tower in ("image", "spot"):
        t0 = time.perf_counter()
        embed.compute_embeddings(model, sections, ev.batch_size, prepared=prepared,
                                 as_device=True, tower=tower, device="cuda")
        torch.cuda.synchronize()
        rates[tower] = n / (time.perf_counter() - t0)
    _, spot_xla = embed.compute_embeddings(xla_model, sections, ev.batch_size,
                                           prepared=prepared, as_device=True, tower="spot",
                                           device="cuda")
    flash_err = float((spot - spot_xla).abs().max())
    log(f"[eval] sweep of {n} spots (B={ev.batch_size}, {-(-n // ev.batch_size)} spot "
        f"batches, remainder {n % ev.batch_size}): flash_attention launches {launches}; "
        f"image tower {rates['image']:.1f} spots/s, spot tower {rates['spot']:.1f} spots/s; "
        f"spot embeddings flash vs xla max abs err {flash_err:.3e} (atol 1e-5)")
    if not flash_err <= 1e-5:
        raise AssertionError(f"flash and xla spot towers differ by {flash_err}")

    bounds = evaluate.section_bounds([s.num_spots for s in sections])
    same_rows = 0
    for f, (start, stop) in enumerate(bounds):
        gt = sections[f].eval_expression
        args = (f, img, spot, prepared["eval_expression"], bounds, gt, ev.top_k, ev.weight_ord)
        t0 = time.perf_counter()
        host = evaluate.evaluate_fold_resident(*args, device="cuda")
        host_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        dev = evaluate.evaluate_fold_resident(*args, device_metrics=True, device="cuda")
        dev_ms = (time.perf_counter() - t0) * 1e3
        for k in host:
            if not (math.isfinite(host[k]) and math.isfinite(dev[k])):
                raise AssertionError(f"fold {f}: non-finite {k}: host {host[k]}, device {dev[k]}")
            if not math.isclose(host[k], dev[k], rel_tol=1e-4, abs_tol=1e-5):
                raise AssertionError(f"fold {f}: {k} host {host[k]} vs device {dev[k]}")
        mask = np.ones(n, bool)
        mask[start:stop] = False
        k_eff = min(ev.top_k, int(mask.sum()))
        _, idx_card = retrieval.find_matches(spot, img[start:stop], k_eff,
                                             torch.from_numpy(mask).cuda())
        _, idx_cpu = retrieval.find_matches(spot.cpu(), img[start:stop].cpu(), k_eff,
                                            torch.from_numpy(mask))
        same = int((idx_card.cpu() == idx_cpu).all(dim=1).sum())
        same_rows += same
        log(f"[eval] fold {f}: {stop - start} queries, K={k_eff}; host metrics "
            f"{ {k: round(v, 6) for k, v in host.items()} } in {host_ms:.2f} ms, device "
            f"metrics {dev_ms:.2f} ms; top-K card vs cpu identical on {same}/{stop - start} rows")
    log(f"[eval] top-K indices identical on card and cpu for {same_rows}/{n} query rows "
        f"(at least 99% required)")
    if same_rows < 0.99 * n:
        raise AssertionError(f"card and cpu retrieval agree on {same_rows}/{n} rows only")
    return model, launches


def phase_serve(cfg, model):
    """PredictionService over a her2st-scale database and its HTTP server."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from mclstexp_tpu_torch.data import synthetic
    from mclstexp_tpu_torch.infer import evaluate, serve
    from mclstexp_tpu_torch.ops.flash_attention import flash_attention

    m, ev, patch = cfg.model, cfg.eval, cfg.data.patch_size
    t0 = time.perf_counter()
    db = synthetic.make_spot_database(m.spot_dim)
    n = sum(s.num_spots for s in db)
    log(f"[serve] database: {len(db)} sections, {n} spots "
        f"({min(s.num_spots for s in db)}-{max(s.num_spots for s in db)} each), made in "
        f"{time.perf_counter() - t0:.1f} s")
    flash_attention.launches = 0
    t0 = time.perf_counter()
    service = serve.PredictionService.from_sections(
        model, db, batch_size=ev.batch_size, top_k=ev.top_k, weight_ord=ev.weight_ord,
        max_batch=256, patch_size=patch, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = flash_attention.launches
    want = m.head_layers * -(-n // ev.batch_size)
    if launches != want:
        raise AssertionError(f"flash_attention launched {launches} times building the "
                             f"database of {n} spots; head_layers x ceil(N/32) = {want}")
    log(f"[serve] database built in {build_s:.2f} s ({n / build_s:.1f} spots/s), "
        f"flash_attention launches {launches}")

    # One LOO fold at her2st scale: the first section held out (its rows
    # masked out of the keys), its queries the image embeddings of random
    # patches; host and device metrics, each timed as a median.
    rng = np.random.default_rng(11)
    stop = db[0].num_spots
    queries = service.embed_patches(
        rng.integers(0, 256, size=(stop, patch, patch, 3), dtype=np.uint8))
    img = torch.zeros_like(service.key_emb)
    img[:stop] = torch.from_numpy(queries).cuda()
    args = (0, img, service.key_emb, service.key_expr,
            evaluate.section_bounds([s.num_spots for s in db]), db[0].eval_expression,
            ev.top_k, ev.weight_ord)
    fold_ms, fold_metrics = {}, {}
    for name, device_metrics, reps in (("host", False, 3), ("device", True, 5)):
        times = []
        for _ in range(reps + 1):  # the first call is a warm-up
            t0 = time.perf_counter()
            fold_metrics[name] = evaluate.evaluate_fold_resident(
                *args, device_metrics=device_metrics, device="cuda")
            times.append((time.perf_counter() - t0) * 1e3)
        fold_ms[name] = sorted(times[1:])[reps // 2]
    for k, v in fold_metrics["host"].items():
        d = fold_metrics["device"][k]
        if not (math.isfinite(v) and math.isfinite(d)
                and math.isclose(v, d, rel_tol=1e-4, abs_tol=1e-5)):
            raise AssertionError(f"her2st-scale fold: {k} host {v} vs device {d}")
    log(f"[serve] LOO fold at her2st scale: {stop} queries against {n - stop} keys, "
        f"K={ev.top_k}: {fold_ms['device']:.2f} ms with device metrics, "
        f"{fold_ms['host']:.2f} ms with host metrics (medians); host and device metrics agree")

    server = serve.make_server(service, "127.0.0.1", 0)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    def result(out):
        if "result_b64" in out:
            return np.frombuffer(base64.b64decode(out["result_b64"]),
                                 np.float32).reshape(out["shape"])
        return np.asarray(out["result"], np.float32)

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            info = json.loads(r.read())
        if r.status != 200 or info["num_keys"] != n or info["top_k"] != ev.top_k:
            raise AssertionError(f"/healthz answered {r.status} {info}")
        for count, b64 in ((1, False), (37, True), (256, True)):
            patches = rng.integers(0, 256, size=(count, patch, patch, 3), dtype=np.uint8)
            if b64:
                body = {"patches_b64": base64.b64encode(patches.tobytes()).decode(),
                        "shape": list(patches.shape), "b64": True}
            else:
                body = {"patches": patches.tolist()}
            times = []
            for _ in range(4):  # the first request of a bucket shape is cold
                t0 = time.perf_counter()
                status, out = post("/predict", body)
                times.append((time.perf_counter() - t0) * 1e3)
            direct_times = []
            for _ in range(3):
                t0 = time.perf_counter()
                direct = service.predict(patches)
                direct_times.append((time.perf_counter() - t0) * 1e3)
            got = result(out)
            if status != 200 or got.shape != (count, m.spot_dim) or not np.isfinite(got).all():
                raise AssertionError(f"/predict {count}: {status}, shape {got.shape}")
            err = float(np.abs(got - direct).max())
            if not err <= 1e-6:
                raise AssertionError(f"/predict {count} differs from service.predict by {err}")
            log(f"[serve] /predict {count} patches ({'base64' if b64 else 'JSON lists'}): "
                f"{times[0]:.1f} ms cold, then {', '.join(f'{t:.1f}' for t in times[1:])} ms "
                f"(median {sorted(times[1:])[1]:.1f}); service.predict "
                f"{', '.join(f'{t:.1f}' for t in direct_times)} ms; equal to "
                f"service.predict (max abs diff {err:.1e})")
        patches = rng.integers(0, 256, size=(8, patch, patch, 3), dtype=np.uint8)
        status, out = post("/embed", {"patches_b64": base64.b64encode(patches.tobytes()).decode(),
                                      "shape": list(patches.shape), "b64": True})
        err = float(np.abs(result(out) - service.embed_patches(patches)).max())
        if status != 200 or result(out).shape != (8, m.projection_dim) or not err <= 1e-6:
            raise AssertionError(f"/embed: {status}, max abs diff {err}")
        log(f"[serve] /embed 8 patches: equal to service.embed_patches (max abs diff {err:.1e})")
        try:
            post("/predict", {"patches_b64": "AAAA", "shape": [1, patch, patch, 3]})
            raise AssertionError("a malformed body was answered 200")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise AssertionError(f"a malformed body got {e.code}, not 400") from e
            log(f"[serve] malformed body: 400 {json.loads(e.read())['error']!r}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    log(f"[serve] server stopped ({'thread still alive' if thread.is_alive() else 'joined'})")
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    return launches


def _reset_patch_counts() -> None:
    from mclstexp_tpu_torch.ops.patches import extract_patches

    _reset_counts()
    extract_patches.launches = 0


def phase_data() -> int:
    """The real-dataset data layer on the card, with standard-library I/O: a
    HER2ST-layout tree and a Visium tree through the port's readers, each
    section's patches cut by the extract_patches kernel; a her2st-width fold
    trained and evaluated on the loaded sections; one "tenx" step on the
    remapped Visium sections. Returns the kernel's launches on this path."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from mclstexp_tpu_torch.config import PRESETS, her2st_config
    from mclstexp_tpu_torch.data import genes, panel, st_dataset, synthetic, visium
    from mclstexp_tpu_torch.data.io import gzip_in_place, load_slide
    from mclstexp_tpu_torch.data.pipeline import (
        ConcatSections, DeviceResidentData, num_train_steps)
    from mclstexp_tpu_torch.data.posremap import PosRemap
    from mclstexp_tpu_torch.infer import embed, evaluate
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_np
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.train.state import create_train_state
    from mclstexp_tpu_torch.train.step import make_train_step
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke", "data")
    shutil.rmtree(base, ignore_errors=True)
    cfg = her2st_config(os.path.join(base, "model_result"))
    p = cfg.data.patch_size

    # HER2ST: 4 sections of 300-700 spots and 2,000 genes (her2st: 32 sections
    # of ~15,000 gene columns), two of them gzipped as the fetched data is
    root = os.path.join(base, "her2st")
    sizes = [int(n) for n in np.random.default_rng(3).integers(300, 701, size=4)]
    t0 = time.perf_counter()
    names, _ = synthetic.write_st_layout(root, num_sections=4, num_spots=sizes,
                                         num_genes=2000, seed=0)
    for name in names[1::2]:
        gzip_in_place(st_dataset.her2st_cnt_path(root, name))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sel = panel.select_panel(panel.her2st_count_frames(root), n_top_genes=1000,
                             panel_size=cfg.model.spot_dim)
    gene_panel = genes.load_panel("her2st", panel.save_panel_artifacts(
        sel, os.path.join(base, "panel"), "her2st"))
    panel_s = time.perf_counter() - t0
    if len(gene_panel) != cfg.model.spot_dim:
        raise AssertionError(f"panel of {len(gene_panel)} genes, not {cfg.model.spot_dim}")

    _reset_patch_counts()
    cache = os.path.join(base, "patch_cache")
    t0 = time.perf_counter()
    sections = st_dataset.load_her2st(root, gene_panel, patch_size=p, cache_dir=cache,
                                      device="cuda")
    load_s = time.perf_counter() - t0
    if extract_patches.launches != len(names):
        raise AssertionError(f"extract_patches launched {extract_patches.launches} times for "
                             f"{len(names)} sections")
    for s in sections:
        want = extract_patches_np(load_slide(st_dataset.her2st_slide_path(root, s.name)),
                                  s.centers, p)
        if not np.array_equal(s.patches, want):
            raise AssertionError(f"section {s.name}: patches differ from extract_patches_np")
    t0 = time.perf_counter()
    sections = st_dataset.load_her2st(root, gene_panel, patch_size=p, cache_dir=cache,
                                      device="cuda")
    hit_s = time.perf_counter() - t0
    if extract_patches.launches != len(names) or not all(
            isinstance(s.patches, np.memmap) for s in sections):
        raise AssertionError("the second load did not hit the patch cache")
    log(f"[data] her2st tree: {len(names)} sections of {sizes} spots x 2000 genes "
        f"({len(names[1::2])} gzipped) written in {write_s:.1f} s; panel of {len(gene_panel)} "
        f"genes ({int(sel.union.sum())} in the union of {len(names)} x 1000 HVGs) in "
        f"{panel_s:.1f} s; load_her2st in {load_s:.1f} s, extract_patches launches "
        f"{extract_patches.launches} (one per section), patches bit-equal to "
        f"extract_patches_np; reloaded from the cache in {hit_s:.2f} s with no launch")

    logger = MetricLogger(echo=False)
    t0 = time.perf_counter()
    state = train_fold(cfg, sections, fold=0, logger=logger, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [r["loss"] for r in logger.records if "loss" in r]
    steps = num_train_steps(sum(s.num_spots for s in sections[1:]), cfg.train.batch_size)
    if state.step != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fold 0: step {state.step} of {steps}, losses {losses}")
    prepared = embed.prepare_eval_arrays(sections, device="cuda")
    img, spot = embed.compute_embeddings(state.model, sections, cfg.eval.batch_size,
                                         prepared=prepared, as_device=True, device="cuda")
    bounds = evaluate.section_bounds([s.num_spots for s in sections])
    args = (0, img, spot, prepared["eval_expression"], bounds, sections[0].eval_expression,
            cfg.eval.top_k, cfg.eval.weight_ord)
    host = evaluate.evaluate_fold_resident(*args, device="cuda")
    dev = evaluate.evaluate_fold_resident(*args, device_metrics=True, device="cuda")
    for k in host:
        if not (math.isfinite(host[k]) and math.isfinite(dev[k])
                and math.isclose(host[k], dev[k], rel_tol=1e-4, abs_tol=1e-5)):
            raise AssertionError(f"fold 0 on the loaded sections: {k} host {host[k]}, "
                                 f"device {dev[k]}")
    log(f"[data] train_fold her2st widths on the loaded sections: {steps} steps in "
        f"{train_s:.1f} s, losses {[round(v, 4) for v in losses]}; fold 0 metrics (host) "
        f"{ {k: round(v, 6) for k, v in host.items()} }, device metrics agree (rtol 1e-4)")

    # Visium: 2 sections in the standard layout, 10x triplets and PPM image.tif
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
    if extract_patches.launches != before + len(vnames):
        raise AssertionError(f"load_visium launched {extract_patches.launches - before} times")
    for s, n in zip(vsecs, vnames):
        want = extract_patches_np(visium.load_bgr(os.path.join(vroot, n, "image.tif")),
                                  s.centers, p)
        if not np.array_equal(s.patches, want) or s.num_genes != vcfg.model.spot_dim:
            raise AssertionError(f"visium {n}: patches or genes ({s.num_genes}) differ")
    remap = PosRemap.build(vsecs)
    remap.save(os.path.join(base, "posremap.npz"))
    loaded = PosRemap.load(os.path.join(base, "posremap.npz"))
    if loaded.vocab != remap.vocab or not np.array_equal(loaded.x_values, remap.x_values):
        raise AssertionError("the saved PosRemap loads back otherwise")
    vsecs = remap.apply_sections(vsecs)
    mcfg = dataclasses.replace(vcfg.model, pos_vocab=remap.vocab)
    vstate = create_train_state(mcfg, vcfg.train, "cuda")
    data = DeviceResidentData(ConcatSections.from_sections(vsecs), "cuda")
    batch = data.take(list(range(vcfg.train.batch_size)))
    g = torch.Generator(device="cuda")
    draws = augment.sample_tenx_draws(augment.reseed(g, 0, 0, 0), vcfg.train.batch_size, "cuda")
    loss = float(make_train_step("tenx", tenx_raw_scale=vcfg.data.visium_raw_scale)(
        vstate, batch, draws))
    if not math.isfinite(loss):
        raise AssertionError(f"visium tenx step loss {loss}")
    log(f"[data] visium tree: {len(vnames)} sections of {[s.num_spots for s in vsecs]} spots, "
        f"panel {len(vsel.panel)} genes; load_visium launches {extract_patches.launches - before}, "
        f"patches (BGR) bit-equal to extract_patches_np; PosRemap vocab {remap.vocab} "
        f"({len(remap.x_values)} x / {len(remap.y_values)} y values); one raw-scale tenx step "
        f"at B={vcfg.train.batch_size}: loss {loss:.4f}")
    return extract_patches.launches


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


def _child_env(repo: str) -> dict:
    path = [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path))


def _cli(argv, repo: str) -> tuple:
    """Run one subcommand of the port's command line in a new process from
    the current directory; returns (its standard output, its kernels' launch
    counts, the seconds from start to exit). A non-zero exit fails the
    phase."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CLI_CHILD] + argv, capture_output=True,
                          text=True, env=_child_env(repo), timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {argv[0]} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    out, _, last = proc.stdout.rstrip("\n").rpartition("\n")
    return out, json.loads(last), seconds


def _json_file(path):
    with open(path) as f:
        return json.load(f)


def phase_cli() -> dict:
    """The port's command line on the card at the her2st preset's width, on a
    synthetic HER2ST tree (4 sections of 300-700 spots x 2,000 genes), each
    subcommand a process of its own as a user starts it: ``hvg
    --select-panel`` (785 genes), ``hvg``, ``train`` (fold 0, one epoch),
    ``eval`` (host, then device metrics), ``predict``, ``export-torch`` and
    ``eval --torch-checkpoint``, ``eval --save-embeddings`` and
    ``--from-embeddings``, and ``serve`` answering a POST of 37 patches as an
    in-process service built from the same checkpoint. Returns the kernels'
    launches over the phase: row_shift 3 per train step, extract_patches one
    per section on the cold patch cache (train) and none on the cache hits."""
    import base64
    import shutil
    import subprocess
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mclstexp_tpu_torch.config import get_config
    from mclstexp_tpu_torch.data import genes, st_dataset, synthetic
    from mclstexp_tpu_torch.data.pipeline import num_train_steps
    from mclstexp_tpu_torch.infer.serve import PredictionService
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.train import checkpoint

    torch.cuda.empty_cache()  # the subcommands' processes share the card with this one
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke", "cli")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "her2st")
    sizes = [int(n) for n in np.random.default_rng(7).integers(300, 701, size=4)]
    t0 = time.perf_counter()
    names, _ = synthetic.write_st_layout(root, num_sections=4, num_spots=sizes,
                                         num_genes=2000, seed=1)
    log(f"[cli] her2st tree: {len(names)} sections of {sizes} spots x 2000 genes, written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("her2st")
    m = cfg.model
    panel_path = os.path.join(work, "panel", "her2st_hvg_panel.npy")
    data = ["--dataset", "her2st", "--data-root", root]
    flags = data + ["--gene-panel", panel_path]
    seconds, counts = {}, {}

    def cli(name, argv):
        out, counts[name], seconds[name] = _cli(argv, repo)
        return out

    cwd = os.getcwd()
    os.chdir(work)  # the CLI's relative defaults: patch_cache/, model_result/, ...
    try:
        out = cli("hvg --select-panel",
                  ["hvg", "--select-panel", "--panel-size", str(m.spot_dim), "--out", "panel"]
                  + data)
        if len(genes.load_panel("her2st", panel_path)) != m.spot_dim:
            raise AssertionError(f"hvg --select-panel: {out.strip()}")
        cli("hvg", ["hvg", "--out", "pre"] + flags)
        for name, n in zip(names, sizes):
            mat = np.load(os.path.join("pre", "her2st", name, "preprocessed_matrix.npy"))
            if mat.shape != (m.spot_dim, n) or not np.isfinite(mat).all():
                raise AssertionError(f"hvg: {name} matrix {mat.shape}")

        cli("train", ["train", "--fold", "0", "--max_epochs", "1"] + flags)
        steps = num_train_steps(sum(sizes[1:]), cfg.train.batch_size)
        trained = counts["train"]
        if trained["extract_patches"] != len(names) or \
                trained["row_shift"] != _shear_launches(steps):
            raise AssertionError(f"train: {trained} for {len(names)} sections and {steps} "
                                 f"steps")
        log_rows = [json.loads(line) for line in open(os.path.join("model_result",
                                                                   "train_log.jsonl"))]
        epoch = [r for r in log_rows if "epoch_loss" in r]
        if len(epoch) != 1 or not math.isfinite(epoch[0]["epoch_loss"]):
            raise AssertionError(f"train_log.jsonl: {log_rows}")
        ms_per_step = sum(sizes[1:]) / epoch[0]["spots_per_sec"] / steps * 1e3
        ckpt = checkpoint.fold_checkpoint_dir("model_result", "her2st", names[0], 0)

        cli("eval", ["eval", "--fold", "0", "--json", "eval.json"] + flags)
        host = _json_file("eval.json")
        cli("eval --device-metrics",
            ["eval", "--fold", "0", "--device-metrics", "--json", "dev.json"] + flags)
        dev = _json_file("dev.json")
        for k, v in host["avg"].items():
            if not (math.isfinite(v) and math.isclose(v, dev["avg"][k], rel_tol=1e-4)):
                raise AssertionError(f"eval: {k} host {v}, device {dev['avg'][k]}")

        out = cli("predict", ["predict", "--fold", "0", "--checkpoint", ckpt,
                              "--out", "pred.npy"] + flags)
        if json.loads(out) != host["per_fold"][0]:
            raise AssertionError(f"predict {out} differs from eval's fold {host['per_fold'][0]}")
        if np.load("pred.npy").shape != (m.spot_dim, sizes[0]):
            raise AssertionError(f"predict --out: {np.load('pred.npy').shape}")

        cli("export-torch", ["export-torch", "--checkpoint", ckpt, "--out", "ref.pt"] + flags)
        cli("eval --torch-checkpoint",
            ["eval", "--fold", "0", "--torch-checkpoint", "ref.pt", "--json", "pt.json"] + flags)
        if _json_file("pt.json") != host:
            raise AssertionError(f"eval --torch-checkpoint {_json_file('pt.json')['avg']} "
                                 f"differs from eval {host['avg']}")

        cli("eval --save-embeddings",
            ["eval", "--fold", "0", "--save-embeddings", "--json", "save.json"] + flags)
        cli("eval --from-embeddings",
            ["eval", "--fold", "0", "--from-embeddings",
             os.path.join("embedding_result", "her2st_result"), "--preprocessed-root", "pre",
             "--json", "dumps.json"] + flags)
        if _json_file("dumps.json")["per_fold"] != _json_file("save.json")["per_fold"]:
            raise AssertionError("eval --from-embeddings scores the dumps otherwise than eval")
        for name, c in counts.items():
            if name != "train" and (c["extract_patches"] or any(c["row_shift"].values())):
                raise AssertionError(f"{name} launched {c}: hvg reads no slide, and every "
                                     f"command after train hits the patch cache")
        launches = {"row_shift": dict(trained["row_shift"]),
                    "extract_patches": trained["extract_patches"]}

        # serve, on a free port; the seconds run to its banner line
        patches = np.ascontiguousarray(st_dataset.load_her2st(
            root, genes.load_panel("her2st", panel_path), names=names[:1],
            patch_size=cfg.data.patch_size,
            cache_dir=os.path.join("patch_cache", f"her2st_{cfg.data.patch_size}"),
            device="cuda")[0].patches[:37])
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "mclstexp_tpu_torch.cli", "serve", "--checkpoint", ckpt,
             "--port", "0", "--exclude-fold", "0"] + flags,
            stdout=subprocess.PIPE, text=True, env=_child_env(repo))
        drain = None
        try:
            banner = None
            for line in proc.stdout:  # ends when the process does
                if line.startswith('{"serving"'):
                    banner = json.loads(line)
                    break
            if banner is None:
                raise AssertionError(f"serve exited {proc.wait()} without serving")
            seconds["serve (to its banner)"] = time.perf_counter() - t0
            drain = threading.Thread(target=proc.stdout.read)  # to its end
            drain.start()
            body = {"patches_b64": base64.b64encode(patches.tobytes()).decode(),
                    "shape": list(patches.shape), "b64": True}
            req = urllib.request.Request(banner["serving"] + "/predict",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"},
                                         method="POST")
            post_ms = []
            for _ in range(2):  # the first request of a bucket shape is cold
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    answer = json.loads(r.read())
                post_ms.append((time.perf_counter() - t0) * 1e3)
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
        sections = st_dataset.load_her2st(
            root, genes.load_panel("her2st", panel_path), with_patches=False, device="cuda")
        service = PredictionService.from_sections(
            model, sections, batch_size=cfg.eval.batch_size, exclude_section=0,
            top_k=cfg.eval.top_k, weight_ord=cfg.eval.weight_ord,
            patch_size=cfg.data.patch_size, device="cuda")
        try:
            want = service.predict(patches)
            info = service.info()
        finally:
            service.close()
        err = float(np.abs(got - want).max())
        if got.shape != (37, m.spot_dim) or not err <= 1e-6 or \
                banner["num_active_keys"] != info["num_active_keys"]:
            raise AssertionError(f"serve: answer {got.shape}, max abs diff {err} from the "
                                 f"in-process service; {banner} vs {info}")
    finally:
        os.chdir(cwd)
    log(f"[cli] model {m.encoder_name} {cfg.data.patch_size} px, spot_dim {m.spot_dim}, "
        f"pos_vocab {m.pos_vocab}, {m.head_layers}x{m.heads_num}x{m.heads_dim} heads, "
        f"projection {m.projection_dim}, batch {cfg.train.batch_size}, fp32")
    log(f"[cli] seconds per subcommand, each a new process from start to exit (the kernels "
        f"already built): " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    log(f"[cli] train: {steps} steps of fold 0 ({sum(sizes[1:])} spots), epoch loss "
        f"{epoch[0]['epoch_loss']:.4f}, {ms_per_step:.1f} ms/step (train_log.jsonl's epoch "
        f"rate, the first step's warm-up included); row_shift {3 * steps} launches "
        f"({launches['row_shift']}), extract_patches {launches['extract_patches']} on the "
        f"cold cache, 0 in every other subcommand")
    log(f"[cli] eval fold 0 {host['avg']}; device metrics within rtol 1e-4; predict equal; "
        f"eval --torch-checkpoint bit-equal; --from-embeddings equal to --save-embeddings")
    log(f"[cli] serve (python -m mclstexp_tpu_torch.cli serve, exited {proc.returncode} on "
        f"SIGTERM): POST /predict of 37 patches in {post_ms[0]:.1f} ms cold, "
        f"{post_ms[1]:.1f} ms warm, equal to the "
        f"in-process service (max abs diff {err:.1e}), {info['num_active_keys']} keys")
    return launches


def _printed_json(out: str):
    """The JSON block a ``baseline`` command prints last (``indent=2``)."""
    return json.loads(out[out.rindex("\n{") + 1:] if "\n{" in out else out[out.index("{"):])


def _bleep_flat_hegs(root, gene_panel, n_genes: int) -> int:
    """How many of the held-out section's 50 highest genes the BLEEP fold
    saved by ``baseline --bleep-retrieval weighted`` predicts constant over
    its queries (its HEG PCC is NaN exactly when one is)."""
    import numpy as np

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.data import st_dataset
    from mclstexp_tpu_torch.infer import embed, metrics
    from mclstexp_tpu_torch.ops import retrieval
    from mclstexp_tpu_torch.train import checkpoint

    cfg = trainer.BaselineConfig(model="bleep", n_genes=n_genes, patch_size=224)
    model = trainer.build_baseline(cfg, "cuda")
    checkpoint.load_checkpoint(os.path.join("model_result", "baselines", "bleep", "best_0"),
                               model)
    sections = st_dataset.load_her2st(root, gene_panel, patch_size=224,
                                      cache_dir=os.path.join("patch_cache", "her2st_224"),
                                      device="cuda")
    img, spot = trainer.bleep_embeddings(model, sections)
    sizes = [s.num_spots for s in sections]
    _, pred = retrieval.retrieve_and_aggregate(
        np.concatenate(embed.split_by_section(spot, sizes)[1:]),
        np.concatenate([s.eval_expression for s in sections[1:]]),
        embed.split_by_section(img, sizes)[0], top_k=50, weight_ord=-1, device="cuda")
    hegs = metrics.heg_indices(sections[0].eval_expression)
    return int((pred[:, hegs].std(axis=0) == 0).sum())


def phase_cli_baseline() -> int:
    """[cli-baseline] the ``baseline`` subcommand on [cli]'s HER2ST tree and
    its 785-gene panel, each command a process of its own, the families at
    their reference widths (the CLI's defaults), fold 0, one epoch:
    HisToGene (112 px) with ``--super-resolution`` (the held-out section's
    dense grid cut by the extract_patches kernel: one launch per section on
    the cold 112-px cache, one for the grid), then ``--load-checkpoint`` of
    its ``best_0`` (no training step; the same JSON and grid predictions bit
    for bit); Hist2ST (zinb 0.25, bake 5), its ``state.pt`` rewritten in the
    reference's Lightning layout and scored by ``--torch-checkpoint`` (the
    trained run's metrics exactly); THItoGene; BLEEP (resnet50, 224 px, the
    weighted top-50 mode). Then, in this process, HisToGene's checkpoint on
    the CPU: ``evaluate_baseline_fold`` and the grid's predictions against
    the card's within 1e-3; the grid's cut (events) and ``sr_predict`` timed
    on the card. Returns HisToGene's extract_patches launches in its
    ``baseline`` process."""
    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.baselines.super_resolution import sr_grid, sr_predict
    from mclstexp_tpu_torch.data import genes, st_dataset
    from mclstexp_tpu_torch.data.io import load_slide
    from mclstexp_tpu_torch.ops.patches import extract_patches, extract_patches_np
    from mclstexp_tpu_torch.train import checkpoint

    torch.cuda.empty_cache()  # the commands' processes share the card with this one
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke", "cli")
    root = os.path.join(work, "her2st")
    panel_path = os.path.join(work, "panel", "her2st_hvg_panel.npy")
    flags = ["--dataset", "her2st", "--data-root", root, "--gene-panel", panel_path]
    names = st_dataset.her2st_section_names(root)
    gene_panel = genes.load_panel("her2st", panel_path)
    n_genes = len(gene_panel)
    seconds, counts, results = {}, {}, {}

    def run(name, argv):
        out, counts[name], seconds[name] = _cli(["baseline"] + argv + flags, repo)
        results[name] = _printed_json(out)
        if any(counts[name]["row_shift"].values()):
            raise AssertionError(f"baseline {name}: row_shift launched {counts[name]}")
        return out

    def finite(name, keys=("hvg_pcc", "heg_pcc", "mse", "mae")):
        bad = {k: results[name][k] for k in keys if not math.isfinite(results[name][k])}
        if bad:
            raise AssertionError(f"baseline {name}: not finite {bad}")

    def saved(family):
        return os.path.join("model_result", "baselines", family, "best_0")

    cwd = os.getcwd()
    os.chdir(work)
    try:
        histogene = ["--baseline", "histogene", "--patch-size", "112", "--max_epochs", "1"]
        out = run("histogene", histogene + ["--super-resolution", "sr.npz"])
        finite("histogene")
        if "epoch=0" not in out or not os.path.isfile(
                os.path.join(saved("histogene"), checkpoint.STATE_FILE)):
            raise AssertionError(f"baseline histogene trained no epoch or saved no best_0: {out}")
        sections = st_dataset.load_her2st(root, gene_panel, patch_size=112, device="cpu",
                                          cache_dir=os.path.join("patch_cache", "her2st_112"))
        grid, _ = sr_grid(sections[0].centers)
        sr = np.load("sr.npz")
        if not np.array_equal(sr["centers"], grid) or \
                sr["predictions"].shape != (len(grid), n_genes) or \
                not np.isfinite(sr["predictions"]).all() or \
                results["histogene"]["super_resolution"]["grid_spots"] != len(grid):
            raise AssertionError(f"--super-resolution: centers {sr['centers'].shape} against "
                                 f"sr_grid's {grid.shape}, predictions {sr['predictions'].shape}")
        if counts["histogene"]["extract_patches"] != len(names) + 1:
            raise AssertionError(f"baseline histogene: extract_patches launched "
                                 f"{counts['histogene']['extract_patches']} times for "
                                 f"{len(names)} sections and the grid")

        out = run("histogene --load-checkpoint",
                  histogene + ["--super-resolution", "sr_loaded.npz",
                               "--load-checkpoint", saved("histogene")])
        loaded, trained = results["histogene --load-checkpoint"], results["histogene"]
        same = {k: v for k, v in loaded.items() if k != "super_resolution"} == \
            {k: v for k, v in trained.items() if k != "super_resolution"}
        if not same or "loss=" in out or \
                counts["histogene --load-checkpoint"]["extract_patches"] != 1 or \
                not np.array_equal(np.load("sr_loaded.npz")["predictions"], sr["predictions"]):
            raise AssertionError(f"--load-checkpoint: {loaded} against the trained run's "
                                 f"{trained}; launches {counts['histogene --load-checkpoint']}")

        hist2st = ["--baseline", "hist2st", "--patch-size", "112"]
        run("hist2st", hist2st + ["--max_epochs", "1"])
        finite("hist2st")
        state = checkpoint.restore_checkpoint(saved("hist2st"))
        torch.save({"epoch": 0, "global_step": state["step"],
                    "state_dict": {f"model.{k}": v for k, v in state["model"].items()}},
                   "hist2st_lightning.ckpt")
        run("hist2st --torch-checkpoint", hist2st + ["--torch-checkpoint",
                                                     "hist2st_lightning.ckpt"])
        if results["hist2st --torch-checkpoint"] != results["hist2st"]:
            raise AssertionError(f"--torch-checkpoint of the Lightning layout: "
                                 f"{results['hist2st --torch-checkpoint']} against the trained "
                                 f"run's {results['hist2st']}")

        run("thitogene", ["--baseline", "thitogene", "--patch-size", "112", "--max_epochs", "1"])
        finite("thitogene")

        run("bleep", ["--baseline", "bleep", "--patch-size", "224", "--max_epochs", "1",
                      "--bleep-retrieval", "weighted"])
        finite("bleep", ("hvg_pcc", "mse", "mae"))
        flat = None
        if not math.isfinite(results["bleep"]["heg_pcc"]):
            flat = _bleep_flat_hegs(root, gene_panel, n_genes)
            if flat == 0:
                raise AssertionError(f"baseline bleep: HEG PCC NaN with no HEG predicted "
                                     f"constant: {results['bleep']}")
        if any(counts[k]["extract_patches"] for k in ("hist2st", "hist2st --torch-checkpoint",
                                                      "thitogene", "bleep")):
            raise AssertionError(f"a load after the first missed the patch cache: {counts}")

        # HisToGene's checkpoint on the CPU: the card's metrics and grid
        cfg = trainer.BaselineConfig(model="histogene", n_genes=n_genes, patch_size=112)
        cpu = trainer.init_baseline(cfg, "cpu")
        checkpoint.apply_checkpoint(cpu, checkpoint.restore_checkpoint(saved("histogene")))
        t0 = time.perf_counter()
        cpu_metrics = trainer.evaluate_baseline_fold(cfg, sections, 0, cpu.model)
        metric_err = max(abs(cpu_metrics[k] - trained[k]) for k in cpu_metrics)
        slide = load_slide(st_dataset.her2st_slide_path(root, names[0]))
        cpu_sr, _ = sr_predict(cpu.model, sections[0], slide, cfg)
        sr_err = float(np.abs(cpu_sr - sr["predictions"]).max())
        cpu_s = time.perf_counter() - t0
        if not (metric_err <= 1e-3 and sr_err <= 1e-3):
            raise AssertionError(f"HisToGene card against CPU: metrics {trained} against "
                                 f"{cpu_metrics} (max abs diff {metric_err:.3e}), grid "
                                 f"predictions off by {sr_err:.3e}")
        del cpu

        # the grid on the card in this process: the cut alone (events; bit-equal
        # to extract_patches_np) and sr_predict from the host slide (host clock)
        card = trainer.build_baseline(cfg, "cuda")
        checkpoint.load_checkpoint(saved("histogene"), card)
        img = torch.from_numpy(slide).cuda()
        xy = torch.from_numpy(grid.astype(np.int64)).cuda()
        cut = extract_patches(img, xy, cfg.patch_size)
        if not np.array_equal(cut.cpu().numpy(), extract_patches_np(slide, grid, cfg.patch_size)):
            raise AssertionError("the grid's patches cut on the card differ from "
                                 "extract_patches_np")
        cut_ms = cuda_ms(lambda: extract_patches(img, xy, cfg.patch_size), iters=20)
        cut_bound_ms = 2 * cut.numel() / HBM_BYTES_PER_S * 1e3  # each patch byte read, written
        predict_ms = []
        for _ in range(4):  # the first call cold
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sr_predict(card, sections[0], slide, cfg)
            predict_ms.append((time.perf_counter() - t0) * 1e3)
        del card, img, xy, cut
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    log(f"[cli-baseline] {len(names)} sections ({[s.num_spots for s in sections]} spots), "
        f"{n_genes} genes, fold 0, one epoch, the families' reference widths; seconds per "
        f"process, start to exit (the kernels already built): "
        + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    log(f"[cli-baseline] HisToGene fold 0 {trained}; --super-resolution grid of "
        f"{len(grid)} spots over {sections[0].name} ({sections[0].num_spots} spots), "
        f"predictions {sr['predictions'].shape} finite; extract_patches launches "
        f"{counts['histogene']['extract_patches']} ({len(names)} sections on the cold 112-px "
        f"cache + the grid), {counts['histogene --load-checkpoint']['extract_patches']} in "
        f"--load-checkpoint (the grid), 0 in the other commands; --load-checkpoint: the same "
        f"JSON and grid predictions bit for bit, no training step")
    log(f"[cli-baseline] Hist2ST {results['hist2st']}; its state.pt as a Lightning .ckpt "
        f"scored by --torch-checkpoint: equal; THItoGene {results['thitogene']}; BLEEP "
        f"(resnet50, weighted top-50) {results['bleep']}"
        + ("" if flat is None else f" ({flat} HEGs predicted constant)"))
    log(f"[cli-baseline] HisToGene's checkpoint on the CPU ({cpu_s:.1f} s): "
        f"evaluate_baseline_fold within {metric_err:.3e} of the card's metrics, the grid's "
        f"predictions within {sr_err:.3e} (atol 1e-3 each)")
    log(f"[cli-baseline] the grid on the card: {len(grid)} patches of {cfg.patch_size} px cut from "
        f"a {slide.shape[0]} x {slide.shape[1]} slide in {cut_ms:.4f} ms (events; bound "
        f"{cut_bound_ms:.4f} ms, bytes), bit-equal to extract_patches_np; sr_predict (host "
        f"slide to predictions, {-(-len(grid) // cfg.bucket) * cfg.bucket} rows) "
        f"{[round(v, 2) for v in predict_ms]} ms (the first cold) on {card_line()}")
    return counts["histogene"]["extract_patches"]


SEG_CASES = ((384, 346, "tail"), (768, 705, "tail"), (4096, 3969, "tail"),
             (768, None, "interleaved"))  # (n, real rows, ids) at (1, 16, n, 64)
SEG_NAMES = {"fwd": "flash_attention[fwd,segments]", "bwd_dkv": "flash_bwd_dkv[segments]",
             "bwd_dq": "flash_bwd_dq[segments]"}
SEG_REPLACES = {"fwd": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
                **BWD_REPLACES}


def _seg_ids(g, n, real, kind):
    """(1, n) int32 segment ids: the padded slide's mask as int32 (real 1,
    padded 0), or ids drawn from {0, 1, 2}."""
    import torch

    if kind == "interleaved":
        return torch.randint(0, 3, (1, n), generator=g, device="cuda", dtype=torch.int32)
    return (torch.arange(n, device="cuda") < real).to(torch.int32)[None]


def _seg_case(g, n, real, kind):
    """The segment kernels at (1, 16, n, 64) against their plain versions:
    errors, determinism, the padded rows, and the times (CUDA-graph replays
    below n = 4,096, events over eager launches at it). Returns one record
    per kernel."""
    import torch
    import torch.nn.functional as F

    from mclstexp_tpu_torch.ops import flash_attention as fa

    shape = (1, 16, n, 64)
    (q, k, v, do, _, _, _, scale), _, _ = _bwd_case(g, shape)
    seg = _seg_ids(g, n, real, kind)
    out, l, m = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
    alone = fa.flash_forward(q, k, v, scale, segment_ids=seg)
    want, want_l, want_m = fa.flash_forward_plain(q, k, v, scale, seg)
    di = (want * do).sum(-1).contiguous()
    args = (q, k, v, do, want_l, want_m, di, scale, seg)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq = fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    errs = {"fwd": max(_max_err((out, alone, m), (want, want, want_m)),
                       float(((l - want_l) / want_l).abs().max())),
            "bwd_dkv": _max_err((dk, dv), fa.flash_bwd_dkv_plain(*args)),
            "bwd_dq": _max_err(dq, fa.flash_bwd_dq_plain(*args))}
    for name, err in errs.items():
        if not err <= FLASH_ATOL:
            raise AssertionError(f"{SEG_NAMES[name]} {shape} {kind}: max abs err {err:.3e} > "
                                 f"{FLASH_ATOL}")
    again = (*fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg),
             *fa.flash_bwd_dkv(*args), fa.flash_bwd_dq(*args))
    if not all(torch.equal(a, b) for a, b in zip((out, l, m, dk, dv, dq), again)):
        raise AssertionError(f"segment kernels {shape} {kind}: two runs differ")
    padded = (seg[0] == 0)
    key_mask = fa.attention_plain(q, k, v, scale, seg != 0)
    gap = float((out - key_mask)[:, :, padded].abs().max()) if padded.any() else 0.0
    if padded.any() and not gap > 1e-3:
        raise AssertionError(f"segment forward {shape}: padded rows equal the key mask's")
    same = fa.same_segment(seg)  # (1, 1, n, n) bool: SDPA's attn_mask
    sdpa_err = float((F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)
                      - want).abs().max())
    if not sdpa_err <= 1e-4:
        raise AssertionError(f"the masked SDPA yardstick computes another function ({sdpa_err})")
    qkv_g = torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2).detach().requires_grad_()

    def library_pair():
        sq, sk, sv = (qkv_g[:, :, i].transpose(1, 2) for i in range(3))
        return torch.autograd.grad((F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=same, scale=scale) * do).sum(), qkv_g)[0]

    def pair():
        o, ll, mm = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
        dd = (o * do).sum(-1).contiguous()
        fa.flash_bwd_dkv(q, k, v, do, ll, mm, dd, scale, seg)
        fa.flash_bwd_dq(q, k, v, do, ll, mm, dd, scale, seg)

    eager = n >= 4096
    timed = (lambda fn, plain=False: cuda_ms(fn, iters=3 if plain else 10,
                                             warmup=1 if plain else 2)) if eager else (
        lambda fn, plain=False: graph_ms(fn))
    kernels = {
        "fwd": (lambda: fa.flash_forward(q, k, v, scale, segment_ids=seg),
                lambda: fa.flash_forward(q, k, v, scale),
                lambda: fa.flash_forward_plain(q, k, v, scale, seg),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)),
        "bwd_dkv": (lambda: fa.flash_bwd_dkv(*args), lambda: fa.flash_bwd_dkv(*args[:-1]),
                    lambda: fa.flash_bwd_dkv_plain(*args), None),
        "bwd_dq": (lambda: fa.flash_bwd_dq(*args), lambda: fa.flash_bwd_dq(*args[:-1]),
                   lambda: fa.flash_bwd_dq_plain(*args), None)}
    pair_ms, library_pair_ms = timed(pair), timed(library_pair)
    rows, split, ctas = fa.cluster_plan(*shape)
    bounds = {"fwd": _flash_fwd_bound(shape)}
    for name, _, _, bound_ms, bound_by, nbytes, flops in _bwd_kernels(shape):
        bounds[name] = (bound_ms, bound_by, nbytes, flops)
    out_records = {}
    for name, (kernel, unmasked, plain, library) in kernels.items():
        _, _, nbytes, flops = bounds[name]
        nbytes += 4 * n  # the segment ids, read once
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        bound_ms, bound_by = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
        ms, plain_ms = timed(kernel), timed(plain, plain=True)
        unmasked_ms = timed(unmasked)
        library_ms = timed(library) if library is not None else None
        log(f"[baselines] {SEG_NAMES[name]} fp32 {shape} {kind} ids"
            f"{'' if real is None else f' ({real} real rows)'} plan rows={rows} split={split} "
            f"ctas={ctas}: max abs err {errs[name]:.3e} (atol {FLASH_ATOL}), deterministic; "
            f"kernel {ms:.5f} ms, without ids {unmasked_ms:.5f} ms, plain {plain_ms:.5f} ms"
            + (f", SDPA with the boolean mask {library_ms:.5f} ms (err {sdpa_err:.1e})"
               if library_ms is not None else "")
            + f", bound {bound_ms:.6f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP), "
            f"{bound_ms / ms:.1%} of bound ({'events' if eager else 'graph replays'})")
        out_records[name] = {"shape": list(shape), "ids": kind, "real": real, "ms": ms,
                             "unmasked_ms": unmasked_ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "max_abs_err": errs[name],
                             "plan": {"rows": rows, "split": split, "ctas": ctas},
                             "pair_ms": pair_ms, "library_pair_ms": library_pair_ms}
    log(f"[baselines] segment pair (forward with residuals + dK/dV + dQ) {shape} {kind}: "
        f"{pair_ms:.5f} ms; SDPA with the boolean mask, forward + backward "
        f"{library_pair_ms:.5f} ms; padded rows {gap:.2e} from the key mask's answer")
    return out_records


def phase_segment_kernels() -> list:
    """The three flash kernels with segment ids at the slide baselines'
    shapes (``SEG_CASES``); one kernels-line entry per kernel, carrying the
    (1, 16, 768, 64) tail case's numbers and every case under ``cases``.
    Bounds as in [kernels] plus the ids' 4 n bytes; ``library_ms`` of the
    forward is SDPA with the boolean same-segment mask (a yardstick; the
    port never calls it), none for dK/dV and dQ alone (the pair carries
    SDPA's forward + backward)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(8)
    entries = {name: {"name": SEG_NAMES[name], "route": "cuda",
                      "source": "mclstexp_tpu_torch/csrc/" + (
                          "flash_attention.cu" if name == "fwd" else "flash_attention_bwd.cu"),
                      "replaces": SEG_REPLACES[name], "cases": [], "max_abs_err": 0.0}
               for name in SEG_NAMES}
    for n, real, kind in SEG_CASES:
        for name, record in _seg_case(g, n, real, kind).items():
            entry = entries[name]
            entry["cases"].append(record)
            entry["max_abs_err"] = max(entry["max_abs_err"], record["max_abs_err"])
            if (n, kind) == (768, "tail"):
                entry.update({key: record[key] for key in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "unmasked_ms",
                    "plan", "pair_ms", "library_pair_ms")})
        torch.cuda.empty_cache()
    return [entries[name] for name in SEG_NAMES]


BASELINE_SPOTS = (346, 613, 705, 524)  # her2st-like sections; fold 0 holds out the first
WHOLE_SLIDE = 63  # a 63 x 63 grid: 3,969 spots, padded to 4,096


def _baseline_sections(n_genes: int):
    """Four synthetic sections at 112 px (``make_section``, a seed, shared
    gene loadings); positions on a grid, all below the 64-entry tables."""
    import numpy as np

    from mclstexp_tpu_torch.data import synthetic

    loadings = np.random.default_rng(30).normal(size=(4, n_genes))
    return [synthetic.make_section(f"B{i + 1}", n, n_genes, patch_size=112, seed=300 + i,
                                   gene_loadings=loadings)
            for i, n in enumerate(BASELINE_SPOTS)]


def _slide_step_ms(state, cfg, batch, n: int = 3) -> float:
    """Host ms per slide step (after one warm-up step), ending in a
    synchronize."""
    import torch

    from mclstexp_tpu_torch.baselines import trainer

    step = trainer.make_slide_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss = step(state, batch, gen)
    torch.cuda.synchronize()
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite loss in the timed slide steps")
    return (time.perf_counter() - t0) / n * 1e3


def _baseline_fold(cfg, sections, want_per_step: int, prefix: str = ""):
    """train_baseline_fold with attn_backend="flash", the counts set to 0
    just before it and read just after: (state, seconds, segment launches,
    losses); the fp32 kernels' counts, or with ``prefix`` "bf16_" the bf16
    ones (and then none of the fp32 ones)."""
    import torch

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(echo=False)
    _reset_counts()
    t0 = time.perf_counter()
    state = trainer.train_baseline_fold(cfg, sections, 0, logger=logger, device="cuda",
                                        attn_backend="flash")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, segments = _flash_counts(prefix=prefix), _flash_counts(True, prefix=prefix)
    steps = len(sections) - 1
    want = (want_per_step * steps,) * 3
    others = _flash_counts() if prefix else (0, 0, 0)
    if state.step != steps or counts != want or segments != want or others != (0, 0, 0):
        raise AssertionError(f"{cfg.model}: {state.step} steps, launches {counts}, segment "
                             f"launches {segments}; expected {steps} steps and {want}")
    losses = [r["loss"] for r in logger.records]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.model}: non-finite or missing losses {losses}")
    return state, seconds, segments, losses


def _slide_grads(model, cfg, batch):
    """The slide loss's gradients, dropout and Hist2ST's bakes drawn from one
    fixed key, so two models of one family draw the same."""
    import torch

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.ops import augment

    model.zero_grad(set_to_none=True)
    trainer.slide_loss(model, cfg, batch, augment.reseed(torch.Generator(device="cuda"), 0, 1)
                       ).backward()
    return {name: p.grad.clone() for name, p in model.named_parameters() if p.grad is not None}


def _fp64_slide_grads(model, cfg, batch):
    """The slide loss's gradients from a float64 copy of ``model`` on the same
    inputs (the patches as the fp32 models see them, then widened) and the
    same draws."""
    import copy

    from mclstexp_tpu_torch.ops import augment

    twin = copy.deepcopy(model).double()
    wide = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    to_float = augment.to_float
    augment.to_float = lambda u: to_float(u).double()
    try:
        return _slide_grads(twin, cfg, wide)
    finally:
        augment.to_float = to_float


def _flash_vs_xla_grads(phase, label, flash_model, cfg, batch, n_spots, near_zero=()):
    """One padded slide's gradients through ``flash_model`` against a model
    with "xla" attention and the same weights, TF32 off: every tensor within
    GRAD_RTOL of its largest magnitude. Where the two part further (a small
    sum of large terms, such as a position table's gradient, keeps their
    rounding), the flash gradient must lie no farther from a float64
    evaluation of the "xla" model than twice the xla gradient does, or
    within GRAD_RTOL of it. Those named with a suffix in ``near_zero``, whose
    gradient is zero up to rounding, must lie below 1e-5 of the largest
    gradient on both sides."""
    import torch

    from mclstexp_tpu_torch.baselines import trainer

    xla = trainer.init_baseline(cfg, "cuda", "xla")
    xla.model.load_state_dict(flash_model.state_dict())
    with _no_tf32():  # TF32 convolutions would round the two models' gradients apart
        got, want = _slide_grads(flash_model, cfg, batch), _slide_grads(xla.model, cfg, batch)
    trained = [p for p in flash_model.parameters() if p.requires_grad]
    if set(got) != set(want) or len(got) != len(trained):
        raise AssertionError(f"{label}: flash and xla gradients cover other parameters: "
                             f"{sorted(got)}")
    worst, worst_name, far = 0.0, None, {}
    largest = max(float(g.abs().max()) for g in want.values())
    for name, gr in got.items():
        if name.endswith(near_zero):
            small = max(float(gr.abs().max()), float(want[name].abs().max()))
            if not small < 1e-5 * largest:
                raise AssertionError(f"{label} {name}: gradient {small:.3e}, not zero up to "
                                     f"rounding (largest gradient {largest:.3e})")
            continue
        scale = float(want[name].abs().max())
        err = float((gr - want[name]).abs().max()) / max(scale, 1e-30)
        if not torch.isfinite(gr).all():
            raise AssertionError(f"{label} {name}: non-finite flash gradient")
        if err > GRAD_RTOL:
            far[name] = err
        elif err >= worst:
            worst, worst_name = err, name
    against = {}
    if far:
        with _no_tf32():
            exact = _fp64_slide_grads(xla.model, cfg, batch)
        for name, err in far.items():
            e = exact[name]
            scale = max(float(e.abs().max()), 1e-30)
            flash_err = float((got[name].double() - e).abs().max()) / scale
            xla_err = float((want[name].double() - e).abs().max()) / scale
            against[name] = f"{err:.2e} / {flash_err:.2e} / {xla_err:.2e}"
            if not flash_err <= max(GRAD_RTOL, 2 * xla_err):
                raise AssertionError(
                    f"{label} {name}: flash vs xla gradient off by {err:.3e} of its largest "
                    f"magnitude {float(want[name].abs().max()):.3e} (allowed {GRAD_RTOL}), and "
                    f"{flash_err:.3e} from float64 against xla's {xla_err:.3e}")
    log(f"[{phase}] {label} gradients on a {n_spots}-spot slide padded to "
        f"{len(batch['mask'])}, flash vs xla, {len(got)} tensors: largest error {worst:.3e} of "
        f"the tensor's largest magnitude ({worst_name}; allowed {GRAD_RTOL}); farther apart "
        f"(flash vs xla / flash vs float64 / xla vs float64): {against or 'none'}")
    return xla


def _whole_slide():
    """One 63 x 63-spot slide (3,969 spots, 4,096 rows) of random patches,
    expression and counts, from a seed."""
    import numpy as np

    from mclstexp_tpu_torch.data.section import Section

    n = WHOLE_SLIDE * WHOLE_SLIDE
    rng = np.random.default_rng(31)
    grid = np.stack(np.meshgrid(np.arange(WHOLE_SLIDE), np.arange(WHOLE_SLIDE)), -1)
    grid = grid.reshape(-1, 2).astype(np.int32)
    return Section("whole", rng.normal(size=(n, 785)).astype(np.float32), grid, grid,
                   patches=rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8),
                   counts=rng.poisson(2.0, (n, 785)).astype(np.float32))


def phase_baselines():
    """HisToGene and THItoGene at the her2st flow's widths on the card (see
    the module docstring, phase 15). Returns the segment launches of the
    HisToGene fold (the main path) and of the THItoGene fold."""
    import dataclasses

    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer

    t0 = time.perf_counter()
    sections = _baseline_sections(785)
    log(f"[baselines] {len(sections)} synthetic sections of {BASELINE_SPOTS} spots at 112 px, "
        f"785 genes, made in {time.perf_counter() - t0:.1f} s")
    cfg = trainer.BaselineConfig(model="histogene", n_genes=785, patch_size=112, n_layers=8,
                                 max_epochs=1)
    state, seconds, counts, losses = _baseline_fold(cfg, sections, 8)
    log(f"[baselines] HisToGene (dim 1024, 8 layers, 16 x 64 heads, mlp 2048) "
        f"train_baseline_fold attn_backend='flash': {state.step} slide steps in {seconds:.1f} s "
        f"incl. set-up, loss {losses}; segment launches forward/dK-dV/dQ {counts} (8 per step)")

    # One padded slide's gradients, flash against xla, from the same weights.
    batch = trainer.slide_tensors(trainer.pad_slide(sections[2], cfg.bucket, False, cfg), "cuda")
    xla = _flash_vs_xla_grads("baselines", "HisToGene", state.model, cfg, batch,
                              sections[2].num_spots)

    # predict_slide's eager scaling on the card: a true division, as on the CPU.
    u8 = torch.arange(256, dtype=torch.uint8)
    want_u8 = (u8.float() / torch.tensor(255.0)).numpy().view(np.uint32)
    if not np.array_equal(trainer.to_float_eager(u8.cuda()).cpu().numpy().view(np.uint32),
                          want_u8):
        raise AssertionError("to_float_eager on the card is not the true division")
    scalar_diff = int(((u8.cuda().float() / 255.0).cpu().numpy().view(np.uint32)
                       != want_u8).sum())
    log(f"[baselines] to_float_eager on the card bit-equal to the true division over 256 "
        f"values (x / 255.0 by a Python scalar differs on {scalar_diff})")

    # predict_slide on the held-out section: the card against the CPU.
    test = sections[0]
    pred = trainer.predict_slide(state.model, test, cfg)
    cpu = trainer.build_baseline(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()})
    want_pred = trainer.predict_slide(cpu, test, cfg)
    err = float(np.abs(pred - want_pred).max())
    if pred.shape != (test.num_spots, 785) or not err <= 1e-3:
        raise AssertionError(f"predict_slide {pred.shape}: card vs CPU off by {err:.3e}")
    metrics = trainer.evaluate_baseline_fold(cfg, sections, 0, state.model)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"evaluate_baseline_fold: {metrics}")
    log(f"[baselines] HisToGene predict_slide on {test.name} ({test.num_spots} spots): card vs "
        f"CPU max abs err {err:.3e} (atol 1e-3); evaluate_baseline_fold {metrics}")

    times = {"xla": [], "flash": []}
    for name in ("xla", "flash", "flash", "xla"):
        times[name].append(_slide_step_ms(xla if name == "xla" else state, cfg, batch))
    log(f"[baselines] HisToGene ms per slide step at {len(batch['mask'])} rows (xla, flash, "
        f"flash, xla; 3 steps each): xla {times['xla']}, flash {times['flash']} on "
        f"{card_line()}")
    del xla, batch, cpu
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, model="thitogene", n_layers=4)
    tstate, seconds, tcounts, tlosses = _baseline_fold(tcfg, sections, 4)
    tpred = trainer.predict_slide(tstate.model, test, tcfg)
    if tpred.shape != (test.num_spots, 785) or not np.isfinite(tpred).all():
        raise AssertionError(f"THItoGene predict_slide: {tpred.shape}, finite "
                             f"{np.isfinite(tpred).all()}")
    log(f"[baselines] THItoGene (4 layers, caps 20 x 64, ViT width 1408, heads (16, 8)) "
        f"train_baseline_fold attn_backend='flash': {tstate.step} slide steps in {seconds:.1f} "
        f"s incl. set-up, loss {tlosses}; segment launches {tcounts} (4 per step); "
        f"predict_slide finite")
    del tstate
    torch.cuda.empty_cache()

    # One whole-slide HisToGene step: 3,969 spots padded to 4,096.
    whole = _whole_slide()
    n = whole.num_spots
    batch = trainer.slide_tensors(trainer.pad_slide(whole, cfg.bucket, False, cfg), "cuda")
    whole_times, peaks = {"xla": [], "flash": []}, {}
    xla = trainer.init_baseline(cfg, "cuda", "xla")
    flash = trainer.init_baseline(cfg, "cuda", "flash")
    for name in ("xla", "flash", "flash", "xla"):
        torch.cuda.reset_peak_memory_stats()
        whole_times[name].append(_slide_step_ms(xla if name == "xla" else flash, cfg, batch,
                                                n=2))
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[baselines] HisToGene whole-slide step, {n} spots padded to {len(batch['mask'])} "
        f"(attention (1, 16, 4096, 64) per layer), ms per slide step (xla, flash, flash, xla; "
        f"2 steps each): xla {whole_times['xla']}, flash {whole_times['flash']}; peak memory "
        f"(both models and their Adam state resident) xla {peaks['xla']:.1f} GiB, flash "
        f"{peaks['flash']:.1f} GiB, on {card_line()}")
    del xla, flash, batch
    torch.cuda.empty_cache()
    return counts, tcounts


HIST2ST_PER_STEP = 48  # 6 train-mode passes (the slide, 5 bakes) x 8 attention layers


def _no_tf32():
    """A context in which cuDNN (convolutions, the LSTM) and cuBLAS take no
    TF32 products: the card against the CPU at 1e-3."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    return ctx()


def phase_hist2st():
    """[hist2st] Hist2ST at the reference widths (dim 1,024, 16 x 64 heads,
    depths 2 / 8 / 4, 785 genes, zinb 0.25, bake 5, lamb 0.5) with "flash" on
    [baselines]' four sections: fold 0 for one epoch (48 segment launches of
    each kernel per slide step: the slide and 5 bakes through 8 layers,
    gradients through all six), flash against xla gradients on one slide,
    ``predict_slide`` card against CPU, ms per slide step at 768 rows (xla,
    flash, flash, xla) and one whole-slide step (4,096 rows, flash) with peak
    memory. Returns the fold's segment launches."""
    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer

    sections = _baseline_sections(785)
    cfg = trainer.BaselineConfig(model="hist2st", n_genes=785, patch_size=112, max_epochs=1)
    state, seconds, counts, losses = _baseline_fold(cfg, sections, HIST2ST_PER_STEP)
    model = state.model
    log(f"[hist2st] Hist2ST (dim {model.dim}, depths {model.depth1}/{model.depth2}/"
        f"{model.depth3}, zinb {cfg.zinb_coef}, bake {trainer.resolve_bake(cfg)}, lamb "
        f"{cfg.lamb}) train_baseline_fold attn_backend='flash': {state.step} slide steps in "
        f"{seconds:.1f} s incl. set-up, loss {losses}; segment launches forward/dK-dV/dQ "
        f"{counts} ({HIST2ST_PER_STEP} per step)")

    batch = trainer.slide_tensors(trainer.pad_slide(sections[2], cfg.bucket, True, cfg), "cuda")
    # zero up to rounding: the conv biases before a batch norm, and coef's last
    # bias, which adds the same to every bake before their softmax
    xla = _flash_vs_xla_grads("hist2st", "Hist2ST", model, cfg, batch, sections[2].num_spots,
                              near_zero=(".dw.0.bias", ".dw.3.bias", "coef.2.bias"))

    test = sections[0]
    cpu = trainer.build_baseline(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    _reset_counts()
    with _no_tf32():
        pred = trainer.predict_slide(model, test, cfg)
    predict_counts = _flash_counts(segments=True)
    want_pred = trainer.predict_slide(cpu, test, cfg)
    err = float(np.abs(pred - want_pred).max())
    if pred.shape != (test.num_spots, 785) or not err <= 1e-3:
        raise AssertionError(f"Hist2ST predict_slide {pred.shape}: card vs CPU off by {err:.3e}")
    if predict_counts != (8, 0, 0):
        raise AssertionError(f"Hist2ST predict_slide launched {predict_counts} segment kernels "
                             "(want 8 forward, no backward)")
    metrics = trainer.evaluate_baseline_fold(cfg, sections, 0, model)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"Hist2ST evaluate_baseline_fold: {metrics}")
    log(f"[hist2st] predict_slide on {test.name} ({test.num_spots} spots; segment launches "
        f"{predict_counts}): card vs CPU max abs err {err:.3e} (atol 1e-3, TF32 off); "
        f"evaluate_baseline_fold {metrics}")

    times = {"xla": [], "flash": []}
    for name in ("xla", "flash", "flash", "xla"):
        times[name].append(_slide_step_ms(xla if name == "xla" else state, cfg, batch))
    log(f"[hist2st] Hist2ST ms per slide step at {len(batch['mask'])} rows (xla, flash, flash, "
        f"xla; 3 steps each): xla {times['xla']}, flash {times['flash']} on {card_line()}")
    del xla, cpu, batch
    torch.cuda.empty_cache()

    whole = _whole_slide()
    batch = trainer.slide_tensors(trainer.pad_slide(whole, cfg.bucket, True, cfg), "cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = [_slide_step_ms(state, cfg, batch, n=2)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[hist2st] Hist2ST whole-slide step, {whole.num_spots} spots padded to "
        f"{len(batch['mask'])} (6 passes of 8 layers of attention (1, 16, 4096, 64) with ids), "
        f"flash: {ms} ms per slide step (2 steps after one); peak memory {peak:.1f} GiB (the "
        f"model, its Adam state and the step's six graphs) on {card_line()}")
    del state, batch
    torch.cuda.empty_cache()
    return counts


def _bleep_cfg(**kw):
    """BLEEP's reference protocol (resnet50, batch 128, AdamW 1e-3, 4 epochs)."""
    from mclstexp_tpu_torch.baselines import trainer

    return trainer.BaselineConfig(model="bleep", n_genes=785, patch_size=224,
                                  encoder_name="resnet50", batch_size=128, **kw)


def phase_bleep(sections) -> None:
    """[bleep] BLEEP (resnet50, 224 px, batch 128, projection 256) on
    [train]'s three sections: ``train_bleep_fold`` for fold 0 (the
    reference's 4 epochs of 450 spots, each 3 batches and a remainder),
    ``bleep_embeddings`` of every
    spot, the held-out section's against the CPU's from the same weights
    (TF32 off), ``evaluate_fold`` of fold 0 in the three retrieval modes
    (finite; the HEG PCC NaN only where a HEG is predicted constant), and
    ms per step at batch 128."""
    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.data.pipeline import DeviceResidentData, ConcatSections
    from mclstexp_tpu_torch.infer import embed, evaluate, metrics
    from mclstexp_tpu_torch.ops import augment, retrieval
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    cfg = _bleep_cfg()
    logger = MetricLogger(echo=False)
    t0 = time.perf_counter()
    state = trainer.train_bleep_fold(cfg, sections, 0, logger=logger, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [r["loss"] for r in logger.records]
    steps = -(-sum(s.num_spots for s in sections[1:]) // cfg.batch_size) * len(losses)
    if state.step != steps or not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"BLEEP fold: {state.step} steps of {steps}, losses {losses}")
    log(f"[bleep] train_bleep_fold resnet50 batch {cfg.batch_size}, {len(losses)} epochs: "
        f"{state.step} steps in "
        f"{seconds:.1f} s incl. set-up, epoch loss {losses}")

    img, spot = trainer.bleep_embeddings(state.model, sections)
    sizes = [s.num_spots for s in sections]
    if img.shape != (sum(sizes), 256) or not (np.isfinite(img).all() and np.isfinite(spot).all()):
        raise AssertionError(f"bleep_embeddings: {img.shape}, finite {np.isfinite(img).all()}")
    cpu = trainer.build_baseline(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()})
    with _no_tf32():
        card = trainer.bleep_embeddings(state.model, sections[:1])
    want = trainer.bleep_embeddings(cpu, sections[:1])
    errs = [float(np.abs(g - w).max()) for g, w in zip(card, want)]
    if not max(errs) <= 1e-3:
        raise AssertionError(f"bleep_embeddings card vs CPU off by {errs}")
    # Each mode's metrics finite, but for the HEG PCC, which the reference
    # averages raw over the 50 highest genes: NaN exactly when one of them is
    # predicted constant over the queries (a Pearson r without a spread), as
    # when the top-1 keys of every query are a handful of spots.
    results, distinct, flat_hegs = {}, {}, {}
    truth = sections[0].eval_expression
    hegs = metrics.heg_indices(truth)
    for mode, (top_k, weight_ord) in {"simple": (1, 0), "average": (50, 0),
                                      "weighted": (50, -1)}.items():
        results[mode] = evaluate.evaluate_fold(
            0, embed.split_by_section(img, sizes)[0], embed.split_by_section(spot, sizes),
            [s.eval_expression for s in sections], top_k=top_k, weight_ord=weight_ord,
            device="cuda")
        _, pred = retrieval.retrieve_and_aggregate(
            np.concatenate(embed.split_by_section(spot, sizes)[1:]),
            np.concatenate([s.eval_expression for s in sections[1:]]),
            embed.split_by_section(img, sizes)[0], top_k=top_k, weight_ord=weight_ord,
            device="cuda")
        distinct[mode] = len(np.unique(pred, axis=0))
        flat_hegs[mode] = int((pred[:, hegs].std(axis=0) == 0).sum())
        heg_ok = math.isfinite(results[mode]["heg_pcc"]) or flat_hegs[mode] > 0
        if not (heg_ok and all(math.isfinite(results[mode][k]) for k in ("hvg_pcc", "mse",
                                                                          "mae"))):
            raise AssertionError(f"BLEEP evaluate_fold {mode}: {results[mode]} ({distinct[mode]} "
                                 f"distinct predictions of {sizes[0]} queries, "
                                 f"{flat_hegs[mode]} HEGs predicted constant)")
    log(f"[bleep] bleep_embeddings of {sum(sizes)} spots; {sections[0].name}'s card vs CPU max "
        f"abs err image {errs[0]:.3e}, spot {errs[1]:.3e} (atol 1e-3, TF32 off); evaluate_fold "
        f"fold 0: {results}; distinct predictions of {sizes[0]} queries {distinct}, HEGs "
        f"predicted constant {flat_hegs}")

    data = DeviceResidentData(ConcatSections.from_sections(sections[1:]), "cuda")
    batch = data.take(np.arange(cfg.batch_size))
    step = trainer.make_bleep_step(cfg)
    gen = torch.Generator(device="cuda")
    step(state, batch, augment.reseed(gen, 0, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        loss = step(state, batch, augment.reseed(gen, 0, i + 1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    if not math.isfinite(float(loss)):
        raise AssertionError("BLEEP: non-finite loss in the timed steps")
    log(f"[bleep] BLEEP ms per step at batch {cfg.batch_size}: {ms:.2f} (5 steps after one) "
        f"on {card_line()}")
    del state, cpu, data
    torch.cuda.empty_cache()


BF16_SHAPES = ((1, 8, 32, 64), (1, 8, 128, 64), (1, 8, 300, 64), (1, 8, 128, 32),
               (1, 8, 128, 128))  # eval sweep, train, ragged; d = 32 and 128
BF16_TRAIN_SHAPE = (1, 8, 128, 64)
BF16_SEG_CASES = ((384, 346, "tail"), (768, 705, "tail"), (768, None, "interleaved"))
BF16_REL = 2.0**-7  # of each bf16 output's largest magnitude (tests/test_torch_port_flash_bf16.py)
BF16_FLOPS_PER_S = 989e12  # H100 SXM published dense bf16 tensor-core rate
BF16_KERNELS = ("fwd", "bwd_dkv", "bwd_dq")
BF16_NAMES = {"fwd": "flash_attention[fwd,bf16]", "bwd_dkv": "flash_bwd_dkv[bf16]",
              "bwd_dq": "flash_bwd_dq[bf16]"}
BF16_SOURCES = {"fwd": "mclstexp_tpu_torch/csrc/flash_attention_bf16.cu",
                "bwd_dkv": "mclstexp_tpu_torch/csrc/flash_attention_bwd_bf16.cu",
                "bwd_dq": "mclstexp_tpu_torch/csrc/flash_attention_bwd_bf16.cu"}


def _bf16_bound(name, shape, segments: bool):
    """(bound ms, bound_by) of a bf16 kernel at ``shape``: q, k, v (and
    dout) read and the outputs written once in bf16, l, m, di in fp32, the
    ids' int32 where given, against the products' operations at 989
    TFLOP/s (bf16 dense)."""
    b, h, n, d = shape
    values, stats = b * h * n * d * 2, b * h * n * 4
    nbytes, flops = {"fwd": (4 * values + 2 * stats, 4), "bwd_dkv": (6 * values + 3 * stats, 8),
                     "bwd_dq": (5 * values + 3 * stats, 6)}[name]
    nbytes += 4 * b * n if segments else 0
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops * b * h * n * n * d / BF16_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _bf16_kernel_plan(name, q, k, v, do) -> dict:
    """The plan a bf16 kernel launches under at q's shape: ``bf16_plan``
    (64-row warpgroup tiles, split 1, CTAs, ring stages) with the staging
    its launcher picks for these inputs (TMA, or the plain-load variant)."""
    from mclstexp_tpu_torch.ops import flash_attention as fa

    plan = dict(zip(("rows", "split", "ctas", "stages"), fa.bf16_plan(*q.shape)))
    inputs = (q, k, v) if name == "fwd" else (q, k, v, do)
    plan["staging"] = "tma" if fa.tma_ok(*inputs) else "plain-load variant"
    return plan


def _plan_text(plan: dict) -> str:
    return ", ".join(f"{key} {value}" for key, value in plan.items())


BF16_EDGES = [(1, 2, n, d) for d in (32, 64, 128) for n in (1, 63, 64, 65, 127, 129)]


def _bf16_edges(g) -> int:
    """The bf16 warpgroup kernels (forward, dK/dV, dQ) at the edges of their
    64-row tiles (``BF16_EDGES``, without and with interleaved segment ids), at d %
    8 != 0 and on views 2 bytes past a 16-byte boundary (the plain-load
    variant): each against its plain bf16 version (bf16 outputs within
    2**-7 of their largest magnitude + 1e-5, l within 1e-5 relative, m
    1e-5) and the same bits on a second run. Returns the cases checked."""
    import torch

    from mclstexp_tpu_torch.ops import flash_attention as fa

    cases = [(shape, ids, 0) for shape in BF16_EDGES for ids in (False, True)]
    cases += [((1, 3, 65, 36), False, 0), ((1, 2, 300, 20), True, 0),
              ((2, 2, 129, 64), True, 1), ((1, 2, 70, 100), False, 1)]
    for (b, h, n, d), ids, shift in cases:
        buf = torch.randn((b, n, 3, h, d + shift), generator=g, device="cuda").bfloat16()
        q, k, v = (buf[:, :, i, :, shift:shift + d].transpose(1, 2) for i in range(3))
        do = torch.randn((b, h, n, d), generator=g, device="cuda").bfloat16()
        seg = (torch.randint(0, 3, (b, n), generator=g, device="cuda", dtype=torch.int32)
               if ids else None)
        scale = d**-0.5
        ro, rl, rm = fa.flash_forward_plain(q, k, v, scale, seg)
        di = (ro.float() * do.float()).sum(-1).contiguous()
        want = (ro, rl, rm, *fa.flash_bwd_dkv_plain(q, k, v, do, rl, rm, di, scale, seg),
                fa.flash_bwd_dq_plain(q, k, v, do, rl, rm, di, scale, seg))

        def run():
            return (*fa.flash_forward(q, k, v, scale, True, seg),
                    *fa.flash_bwd_dkv(q, k, v, do, rl, rm, di, scale, seg),
                    fa.flash_bwd_dq(q, k, v, do, rl, rm, di, scale, seg))

        got, again = run(), run()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"bf16 edges {(b, h, n, d)} ids {ids}: two runs differ")
        if fa.tma_ok(q, k, v, do) != (shift == 0 and d % 8 == 0):
            raise AssertionError(f"bf16 edges {(b, h, n, d)}: staging not as expected")
        for i, (x, w) in enumerate(zip(got, want)):
            if i == 1:
                off, tol = float(((x - w) / w).abs().max()), 1e-5
            elif i == 2:
                off, tol = float((x - w).abs().max()), 1e-5
            else:
                off = float((x.float() - w.float()).abs().max())
                tol = BF16_REL * float(w.float().abs().max()) + 1e-5
            if not off <= tol:
                raise AssertionError(f"bf16 edges {(b, h, n, d)} ids {ids} output {i}: off "
                                     f"{off:.3e} > {tol:.3e}")
    return len(cases)


def _bf16_case(g, shape, seg=None, events=False, kind=""):
    """The three bf16 kernels at ``shape`` on the views of a (b, n, 3, h, d)
    bf16 qkv buffer (with segment ids ``seg`` or none): each against its
    plain bf16 version (bf16 outputs within 2**-7 of their largest
    magnitude + 1e-5, l within 1e-5 relative, m 1e-5), the same bits on a
    second run; timed (graph replays, or events over eager launches with
    ``events``) beside the fp32 kernel on the same values, the plain
    version and, for the forward, bf16 SDPA (with the boolean same-segment
    mask where ids are given, and without); the backward kernels' records
    carry the pair (forward with residuals + dK/dV + dQ) against
    ``torch.autograd.grad`` of bf16 SDPA. Returns {kernel: record}."""
    import torch
    import torch.nn.functional as F

    from mclstexp_tpu_torch.ops import flash_attention as fa

    b, h, n, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=g, device="cuda").bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(shape, generator=g, device="cuda").bfloat16()
    scale = d**-0.5
    ro, rl, rm = fa.flash_forward_plain(q, k, v, scale, seg)
    di = (ro.float() * do.float()).sum(-1).contiguous()
    args = (q, k, v, do, rl, rm, di, scale, seg)
    qkv32 = qkv.float()
    q32, k32, v32 = (qkv32[:, :, i].transpose(1, 2) for i in range(3))
    do32 = do.float()
    o32, l32, m32 = fa.flash_forward(q32, k32, v32, scale, True, seg)
    args32 = (q32, k32, v32, do32, l32, m32, (o32 * do32).sum(-1).contiguous(), scale, seg)
    calls = {"fwd": (lambda: fa.flash_forward(q, k, v, scale, True, seg),
                     lambda: fa.flash_forward_plain(q, k, v, scale, seg),
                     lambda: fa.flash_forward(q32, k32, v32, scale, True, seg)),
             "bwd_dkv": (lambda: fa.flash_bwd_dkv(*args), lambda: fa.flash_bwd_dkv_plain(*args),
                         lambda: fa.flash_bwd_dkv(*args32)),
             "bwd_dq": (lambda: (fa.flash_bwd_dq(*args),), lambda: (fa.flash_bwd_dq_plain(*args),),
                        lambda: (fa.flash_bwd_dq(*args32),))}
    mask = None if seg is None else fa.same_segment(seg)
    timer = (lambda fn: cuda_ms(fn, iters=10, warmup=2)) if events else graph_ms
    plain_timer = (lambda fn: cuda_ms(fn, iters=3, warmup=1)) if events else graph_ms
    qkv_g = qkv.clone().requires_grad_()

    def pair():
        o, ll, mm = fa.flash_forward(q, k, v, scale, True, seg)
        dd = (o.float() * do.float()).sum(-1).contiguous()
        fa.flash_bwd_dkv(q, k, v, do, ll, mm, dd, scale, seg)
        fa.flash_bwd_dq(q, k, v, do, ll, mm, dd, scale, seg)

    def library_pair():  # views taken inside: autograd replays them on the capturing stream
        sq, sk, sv = (qkv_g[:, :, i].transpose(1, 2) for i in range(3))
        out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, scale=scale)
        return torch.autograd.grad((out * do).float().sum(), qkv_g)[0]

    pair_ms, library_pair_ms = timer(pair), timer(library_pair)
    log(f"[bf16] forward with residuals + dK/dV + dQ {shape}"
        f"{' ids ' + kind if seg is not None else ''}: {pair_ms:.5f} ms; bf16 SDPA forward + "
        f"backward{' (masked)' if mask is not None else ''} {library_pair_ms:.5f} ms; pair / "
        f"SDPA {pair_ms / library_pair_ms:.3f}")
    records = {}
    for name, (kernel, plain, fp32) in calls.items():
        got, want, again = kernel(), plain(), kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"bf16 {name} {shape}: two runs differ")
        err, worst = 0.0, 0.0  # bf16 outputs: abs error, and its share of the tolerance
        for i, (x, w) in enumerate(zip(got, want)):
            if name == "fwd" and i == 1:  # l, fp32: relative
                off, tol = float(((x - w) / w).abs().max()), 1e-5
            elif name == "fwd" and i == 2:  # m, fp32
                off, tol = float((x - w).abs().max()), 1e-5
            else:
                if x.dtype != torch.bfloat16:
                    raise AssertionError(f"bf16 {name} {shape}: output {i} is {x.dtype}")
                off = float((x.float() - w.float()).abs().max())
                tol = BF16_REL * float(w.float().abs().max()) + 1e-5
                err = max(err, off)
            worst = max(worst, off / tol)
        if not worst <= 1.0:
            raise AssertionError(f"bf16 {name} {shape}: off by {worst:.2f} of its tolerance")
        bound_ms, bound_by = _bf16_bound(name, shape, seg is not None)
        rec = {"ms": timer(kernel), "fp32_ms": timer(fp32), "plain_ms": plain_timer(plain),
               "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
               "tolerance_share": worst, "plan": _bf16_kernel_plan(name, q, k, v, do)}
        if name == "fwd":
            rec["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale))
            if mask is not None:
                rec["library_unmasked_ms"] = timer(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        else:
            rec["pair_ms"], rec["library_pair_ms"] = pair_ms, library_pair_ms
        records[name] = rec
        sdpa = (f", bf16 SDPA{' (masked)' if mask is not None else ''} "
                f"{rec['library_ms']:.5f} ms, kernel / SDPA "
                f"{rec['ms'] / rec['library_ms']:.3f}" if name == "fwd" else "")
        log(f"[bf16] {BF16_NAMES[name]} {shape}{' ids ' + kind if seg is not None else ''} plan "
            f"{_plan_text(rec['plan'])}: max abs err {err:.3e} ({worst:.2f} of the "
            f"tolerance), deterministic; kernel {rec['ms']:.5f} ms, fp32 kernel "
            f"{rec['fp32_ms']:.5f} ms (bf16 / fp32 {rec['ms'] / rec['fp32_ms']:.3f}), plain "
            f"{rec['plain_ms']:.5f} ms{sdpa}, bound {bound_ms:.6f} ms by {bound_by}, "
            f"{bound_ms / rec['ms']:.1%} of bound{' (events)' if events else ''}")
    return records


def phase_bf16_kernels() -> list:
    """[bf16] the bf16 flash kernels against their plain bf16 versions at
    their tile edges (``_bf16_edges``), ``BF16_SHAPES``, the segment shapes
    of [baselines] and (1, 16, 4,096, 64) (events), each beside the fp32
    kernel, bf16 SDPA and its bound, each with its plan.
    Returns one kernels-line entry per kernel with the training shape's
    numbers, every case under ``cases`` and the long one under ``long``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(10)
    edges = _bf16_edges(g)
    log(f"[bf16] the warpgroup forward, dK/dV and dQ at {edges} tile-edge cases (n = 1, 63, 64, "
        f"65, 127, 129 at d = 32 / 64 / 128, with and without ids; d % 8 != 0 and misaligned "
        f"views on the plain-load variant): within tolerance of the plain versions, "
        f"deterministic")
    cases = [(str(shape), _bf16_case(g, shape)) for shape in BF16_SHAPES]
    for n, real, kind in BF16_SEG_CASES:
        cases.append((f"(1, 16, {n}, 64) {kind}", _bf16_case(g, (1, 16, n, 64),
                                                            _seg_ids(g, n, real, kind),
                                                            kind=kind)))
    long = _bf16_case(g, BWD_LONG, events=True)
    train = dict(cases)[str(BF16_TRAIN_SHAPE)]
    entries = []
    for name in BF16_KERNELS:
        rec = train[name]
        entries.append({
            "name": BF16_NAMES[name], "route": "cuda", "source": BF16_SOURCES[name],
            "replaces": SEG_REPLACES[name], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"), "fp32_ms": rec["fp32_ms"],
            "max_abs_err": max(c[name]["max_abs_err"] for _, c in cases + [("", long)]),
            "plan": rec["plan"], "cases": {key: c[name] for key, c in cases},
            "long": {"shape": list(BWD_LONG), **long[name]}})
    torch.cuda.empty_cache()
    return entries


def _bf16_counts(segments: bool = False) -> tuple:
    return _flash_counts(segments, prefix="bf16_")


def phase_bf16_train(cfg, sections) -> tuple:
    """[bf16] the her2st flagship in bf16 with "flash": ``train_fold`` for one
    epoch (the counts set to 0 just before it and read just after: every
    attention of the spot tower in the bf16 kernels, none in the fp32
    ones; row_shift's 3 shears a step on bf16 images), the checkpoint's
    saved dtype, the held-out section's embeddings and the LOO fold's
    metrics; then ms/step and peak memory bf16 against fp32 (flash, fresh
    weights) in this process. Returns the bf16 launches (fwd, dK/dV, dQ)."""
    import dataclasses

    import torch

    from mclstexp_tpu_torch.data.pipeline import num_train_steps
    from mclstexp_tpu_torch.infer import embed, evaluate
    from mclstexp_tpu_torch.ops.row_shift import row_shift
    from mclstexp_tpu_torch.train import checkpoint
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.train.state import create_train_state
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    root = os.path.dirname(os.path.abspath(__file__))
    bcfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="bfloat16", attn_backend="flash"),
        train=dataclasses.replace(cfg.train, checkpoint_dir=os.path.join(
            root, "build", "chip_smoke", "model_result_bf16")))
    m = bcfg.model
    steps = num_train_steps(sum(s.num_spots for s in sections[1:]), cfg.train.batch_size)
    logger = MetricLogger(echo=True)
    t0 = time.perf_counter()
    _reset_counts()
    state = train_fold(bcfg, sections, fold=0, logger=logger, device="cuda")
    torch.cuda.synchronize()
    counts, fp32_counts = _bf16_counts(), _flash_counts()
    shifts = dict(row_shift.kernel_launches)
    seconds = time.perf_counter() - t0
    want = m.head_layers * steps
    losses = [r["loss"] for r in logger.records if "loss" in r]
    if state.step != steps or not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bf16 fold: {state.step} steps of {steps}, losses {losses}")
    if counts != (want,) * 3 or fp32_counts != (0, 0, 0):
        raise AssertionError(f"bf16 fold: bf16 flash launches {counts} (want {want} each), "
                             f"fp32 launches {fp32_counts} (want none)")
    if shifts != _shear_launches(steps):
        raise AssertionError(f"bf16 fold: row_shift launched {shifts} in {steps} steps")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("bf16 fold: a parameter left fp32")
    saved = checkpoint.fold_checkpoint_dir(bcfg.train.checkpoint_dir, bcfg.data.dataset,
                                           sections[0].name, 0)
    if not os.path.isfile(os.path.join(saved, checkpoint.STATE_FILE)):
        raise AssertionError(f"bf16 fold: no checkpoint in {saved}")
    log(f"[bf16] train_fold dtype='bfloat16' attn_backend='flash': {steps} steps in "
        f"{seconds:.1f} s incl. set-up; running losses {losses}; bf16 flash launches "
        f"forward/dK-dV/dQ {counts}, fp32 {fp32_counts}; row_shift {shifts}; checkpoint "
        f"saved")

    _reset_counts()
    prepared = embed.prepare_eval_arrays(sections, device="cuda")
    img, spot = embed.compute_embeddings(state.model, sections, bcfg.eval.batch_size,
                                         prepared=prepared, as_device=True, device="cuda")
    torch.cuda.synchronize()
    eval_counts = _bf16_counts()
    sizes = [s.num_spots for s in sections]
    if img.dtype != torch.float32 or not (torch.isfinite(img).all() and
                                          torch.isfinite(spot).all()):
        raise AssertionError(f"bf16 embeddings: {img.dtype}, finite {torch.isfinite(img).all()}")
    metrics = evaluate.evaluate_fold_resident(
        0, img, spot, prepared["eval_expression"], evaluate.section_bounds(sizes),
        sections[0].eval_expression, top_k=bcfg.eval.top_k, weight_ord=bcfg.eval.weight_ord,
        device="cuda")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"bf16 LOO fold 0: {metrics}")
    log(f"[bf16] embeddings of {sum(sizes)} spots (fp32 out, bf16 towers; bf16 forward "
        f"launches {eval_counts[0]}) and LOO fold 0: {metrics}")

    batch, draws = _step_batch(cfg, sections)
    fp32 = create_train_state(dataclasses.replace(m, dtype="float32"), bcfg.train, "cuda")
    times, peaks = {"bf16": [], "fp32": []}, {}
    for name in ("bf16", "fp32", "fp32", "bf16"):
        torch.cuda.reset_peak_memory_stats()
        times[name].append(_step_ms(cfg, state if name == "bf16" else fp32, batch, draws, n=3))
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[bf16] flagship ms/step at B={cfg.train.batch_size}, flash (bf16, fp32, fp32, bf16; "
        f"3 steps each): bf16 {times['bf16']}, fp32 {times['fp32']}; peak memory bf16 "
        f"{peaks['bf16']:.1f} GiB, fp32 {peaks['fp32']:.1f} GiB, on {card_line()}")
    del fp32, state, batch
    torch.cuda.empty_cache()
    return counts


def phase_bf16_cli() -> None:
    """[bf16] the command line in bf16 on [cli]'s tree, each a process of its
    own: ``train --dtype bfloat16`` (fold 0, one epoch) and ``eval --dtype
    bfloat16`` of its checkpoint (as in JAX, every subcommand computes in
    ``--dtype``'s type; a checkpoint keeps no dtype)."""
    from mclstexp_tpu_torch.train import checkpoint

    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke", "cli")
    flags = ["--dataset", "her2st", "--data-root", os.path.join(work, "her2st"),
             "--gene-panel", os.path.join(work, "panel", "her2st_hvg_panel.npy"),
             "--checkpoint-dir", "model_result_bf16"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        _, trained, train_s = _cli(["train", "--fold", "0", "--max_epochs", "1",
                                    "--dtype", "bfloat16"] + flags, repo)
        names = sorted(os.listdir(os.path.join("model_result_bf16", "her2st")))
        if not any(os.path.isfile(os.path.join("model_result_bf16", "her2st", nm, "best_0",
                                               checkpoint.STATE_FILE)) for nm in names):
            raise AssertionError(f"cli train --dtype bfloat16 saved no fold 0 checkpoint: {names}")
        _, _, eval_s = _cli(["eval", "--fold", "0", "--dtype", "bfloat16", "--json",
                             "eval_bf16.json"] + flags, repo)
        avg = _json_file("eval_bf16.json")["avg"]
        if not all(math.isfinite(v) for v in avg.values()):
            raise AssertionError(f"cli eval of the bf16 checkpoint: {avg}")
    finally:
        os.chdir(cwd)
    log(f"[bf16] cli train --dtype bfloat16 {train_s:.2f} s (row_shift {trained['row_shift']}), "
        f"eval of its checkpoint {eval_s:.2f} s: {avg}")


def phase_bf16_baselines() -> tuple:
    """[bf16] HisToGene, THItoGene and Hist2ST in bf16 at [baselines]' widths
    with "flash": a HisToGene fold (one epoch, 3 slide steps: 8 bf16 segment
    launches of each kernel per step, none in fp32), ms per slide step and
    peak memory bf16 against fp32 at 768 rows and at the whole 3,969-spot
    slide (4,096 rows); a THItoGene fold; a Hist2ST fold (48 per step).
    Returns the bf16 segment launches of the three folds."""
    import dataclasses

    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer

    sections = _baseline_sections(785)
    cfg = trainer.BaselineConfig(model="histogene", n_genes=785, patch_size=112, n_layers=8,
                                 max_epochs=1, dtype="bfloat16")
    state, seconds, counts, losses = _baseline_fold(cfg, sections, 8, prefix="bf16_")
    log(f"[bf16] HisToGene bf16 train_baseline_fold: {state.step} slide steps in {seconds:.1f} "
        f"s incl. set-up, loss {losses}; bf16 segment launches {counts} (8 per step)")
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def timed(batch, bf16_state, n):
        fp32_state = trainer.init_baseline(cfg32, "cuda", "flash")
        times, peaks = {"bf16": [], "fp32": []}, {}
        for name in ("bf16", "fp32", "fp32", "bf16"):
            torch.cuda.reset_peak_memory_stats()
            times[name].append(_slide_step_ms(bf16_state if name == "bf16" else fp32_state,
                                              cfg if name == "bf16" else cfg32, batch, n=n))
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        return times, peaks

    batch = trainer.slide_tensors(trainer.pad_slide(sections[2], cfg.bucket, False, cfg), "cuda")
    times, peaks = timed(batch, state, 3)
    log(f"[bf16] HisToGene ms per slide step at {len(batch['mask'])} rows, flash (bf16, fp32, "
        f"fp32, bf16; 3 steps each): bf16 {times['bf16']}, fp32 {times['fp32']}; peak memory "
        f"bf16 {peaks['bf16']:.1f} GiB, fp32 {peaks['fp32']:.1f} GiB")
    whole = _whole_slide()
    n = whole.num_spots
    batch = trainer.slide_tensors(trainer.pad_slide(whole, cfg.bucket, False, cfg), "cuda")
    _reset_counts()
    times, peaks = timed(batch, trainer.init_baseline(cfg, "cuda", "flash"), 2)
    if _bf16_counts(segments=True)[0] == 0:
        raise AssertionError("the bf16 whole-slide steps launched no bf16 segment kernel")
    log(f"[bf16] HisToGene whole-slide step, {n} spots padded to {len(batch['mask'])} "
        f"(attention (1, 16, 4096, 64) with ids per layer), ms per slide step (bf16, fp32, fp32, "
        f"bf16; 2 steps each): bf16 {times['bf16']}, fp32 {times['fp32']}; peak memory bf16 "
        f"{peaks['bf16']:.1f} GiB, fp32 {peaks['fp32']:.1f} GiB, on {card_line()}")
    del state, batch
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, model="thitogene", n_layers=4)
    tstate, seconds, tcounts, tlosses = _baseline_fold(tcfg, sections, 4, prefix="bf16_")
    tpred = trainer.predict_slide(tstate.model, sections[0], tcfg)
    if tpred.shape != (sections[0].num_spots, 785) or not np.isfinite(tpred).all():
        raise AssertionError(f"THItoGene bf16 predict_slide: {tpred.shape}")
    log(f"[bf16] THItoGene bf16 train_baseline_fold: {tstate.step} slide steps in {seconds:.1f} "
        f"s incl. set-up, loss {tlosses}; bf16 segment launches {tcounts} (4 per step); "
        f"predict_slide finite")
    del tstate
    torch.cuda.empty_cache()

    hcfg = trainer.BaselineConfig(model="hist2st", n_genes=785, patch_size=112, max_epochs=1,
                                  dtype="bfloat16")
    hstate, seconds, hcounts, hlosses = _baseline_fold(hcfg, sections, HIST2ST_PER_STEP,
                                                       prefix="bf16_")
    hpred = trainer.predict_slide(hstate.model, sections[0], hcfg)
    if hpred.shape != (sections[0].num_spots, 785) or not np.isfinite(hpred).all():
        raise AssertionError(f"Hist2ST bf16 predict_slide: {hpred.shape}")
    log(f"[bf16] Hist2ST bf16 train_baseline_fold: {hstate.step} slide steps in {seconds:.1f} s "
        f"incl. set-up, loss {hlosses}; bf16 segment launches {hcounts} ({HIST2ST_PER_STEP} per "
        f"step), fp32 none; predict_slide finite")
    del hstate
    torch.cuda.empty_cache()
    return counts, tcounts, hcounts


def phase_bf16_bleep(sections) -> None:
    """[bf16] one BLEEP step in bf16 (resnet50, batch 128) on [train]'s
    sections: a finite loss, fp32 parameters."""
    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData

    cfg = _bleep_cfg(dtype="bfloat16")
    state = trainer.init_baseline(cfg, "cuda")
    batch = DeviceResidentData(ConcatSections.from_sections(sections[1:]), "cuda").take(
        np.arange(cfg.batch_size))
    loss = float(trainer.make_bleep_step(cfg)(state, batch, torch.Generator(device="cuda")))
    if not math.isfinite(loss) or any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError(f"BLEEP bf16 step: loss {loss}")
    log(f"[bf16] BLEEP bf16 step (resnet50, batch {cfg.batch_size}): loss {loss:.4f}")
    del state
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    entries = phase_kernels()
    flash_entry = phase_flash_kernels()
    bwd_entries = phase_flash_bwd_kernels()
    phase_flash_bwd_long(flash_entry, bwd_entries)
    patch_entry = phase_patches()
    cfg, state, sections, launches = phase_train()
    for entry in entries:
        entry["launches"] = launches[entry["kernel"]]
    phase_reference(cfg, state, sections)
    phase_step_time(cfg, state, sections)
    fcfg, steps, counts = phase_train_flash(cfg, sections, state)
    phase_resume(fcfg, sections, steps)
    phase_tenx(cfg, sections, state)
    eval_model, eval_launches = phase_eval(cfg, sections)
    serve_launches = phase_serve(cfg, eval_model)
    patch_entry["launches"] = phase_data()
    cli_launches = phase_cli()
    baseline_launches = phase_cli_baseline()
    seg_entries = phase_segment_kernels()
    seg_counts, thitogene_counts = phase_baselines()
    hist2st_counts = phase_hist2st()
    phase_bleep(sections)
    bf16_entries = phase_bf16_kernels()
    bf16_counts = phase_bf16_train(cfg, sections)
    phase_bf16_cli()
    bf16_seg, bf16_tseg, bf16_hseg = phase_bf16_baselines()
    phase_bf16_bleep(sections)
    for entry, count, seg, tseg, hseg in zip(bf16_entries, bf16_counts, bf16_seg, bf16_tseg,
                                             bf16_hseg):
        entry["launches"] = count  # the bf16 flagship fold, the bf16 slice's main path
        entry["launches_by_path"] = {"bf16_train_flash": count, "histogene_fold": seg,
                                     "thitogene_fold": tseg, "hist2st_fold": hseg}
    for entry, count, hcount, other in zip(seg_entries, seg_counts, hist2st_counts,
                                           thitogene_counts):
        entry["launches"] = hcount  # the Hist2ST fold, this slice's main path
        entry["launches_by_path"] = {"hist2st_fold": hcount, "histogene_fold": count,
                                     "thitogene_fold": other}
    # Launches on this slice's main path, flash training; the forward's
    # counts on the eval and serving paths beside them.
    flash_entry["launches"] = counts[0]
    flash_entry["launches_by_path"] = {"train_flash": counts[0], "eval": eval_launches,
                                       "serve": serve_launches}
    for entry, count in zip(bwd_entries, counts[1:]):
        entry["launches"] = count
    # The command line's path ([cli]) beside each kernel's own main path
    for entry in entries:
        entry["launches_by_path"] = {"train": entry["launches"],
                                     "cli": cli_launches["row_shift"][entry["kernel"]]}
    # extract_patches on this slice's main path, `baseline` with --super-resolution
    patch_entry["launches_by_path"] = {"data": patch_entry["launches"],
                                       "cli": cli_launches["extract_patches"],
                                       "cli_baseline": baseline_launches}
    patch_entry["launches"] = baseline_launches
    entries += [flash_entry, *bwd_entries, patch_entry, *seg_entries, *bf16_entries]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
