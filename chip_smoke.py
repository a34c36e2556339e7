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
     bench's whole-slide width (1, 16, 4,096, 64), on the warpgroup kernels
     that ``fp32_plan`` picks there. An fp32 flash kernel's bound is the
     larger of its bytes at 3.35 TB/s and its products as three tf32 ones
     (3xTF32) at the 495 TFLOP/s tensor-core rate;
  3a. linear: the fp32 linear kernel (``ops/linear.py``, 3xTF32 on
     ``wgmma`` after a split pass) at HisToGene's six products on a whole
     slide's 4,096 rows (the patch embedding's 37,632-deep input and the
     785-wide gene head included): forward, dX and dW each against float64
     within twice cuBLAS fp32's own error on the same inputs, a bound that
     cuBLAS with TF32 fails; through autograd the same bits on a second run
     and three products counted; each product (with its split pass) timed
     by CUDA-graph replays beside its 3xTF32 bound (3 * 2 m n k at 495
     TFLOP/s), cuBLAS fp32 and cuBLAS with TF32;
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
  9a. train-dp: [train-flash]'s fold under a one-rank NCCL group
     (``make_mesh``): the data-parallel step (global batch norms,
     ``symmetric_infonce_gathered``, the gradient average), the same kernel
     launches as [train-flash]; losses and parameters against the same fold
     without a group (whether bit-equal is logged); ms/step against the
     step without a group;
  9b. ring-tp: over [train-dp]'s one-rank group, ``ring_self_attention``
     at the spot tower's (n, 8, 64), n = 128 and 4,096, and the block merge
     over 4 blocks of the 4,096 rows in one process (the ring's schedule,
     rotated by indexing), forward and backward against dense attention,
     timed beside dense attention and the fp32 flash pair; the flagship step
     under a (1, 1) ("data", "seq") mesh with "ring" and under a (1, 1)
     ("data", "model") mesh after ``shard_train_state`` with "flash" (at
     model 1 every parameter stays replicated, as in JAX), their launches,
     losses and peak memory, ms/step beside [train-dp]'s step;
 9c. stream: [train]'s fold past the device budget
     (``device_data_budget_bytes=0``, batches through
     ``prefetch_to_device``) against the resident fold, in a process with
     deterministic algorithms: bit-equal, ms per step of each;
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
 15a. cli-dp: ``torchrun --nproc-per-node=1`` running ``train --fold 0``
     and ``baseline --baseline histogene --dp`` on [cli]'s tree with a fresh
     patch cache (each child's pre-cut launches extract_patches once per
     section): the data-parallel checkpoint against [cli]'s, the slide-DP
     scores against [cli-baseline]'s; then BLEEP's fold with a one-rank mesh
     in this process against the fold without one;
 16. baselines: the flash kernels with segment ids (the padded slide's mask
     as int32, as the JAX package builds ``SegmentIds``) at the slide
     baselines' (1, 16, n, 64): n = 384, 768 and 4,096 with padded tails and
     one case of interleaved ids (all on the fp32 warpgroup kernels under
     ``fp32_plan``), each kernel within 2e-5 of its plain
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
     HisToGene step at 3,969 spots (padded to 4,096), xla against flash,
     the flash steps' fp32 warpgroup launches counted (``wg_launches``: 8
     of each kernel a step), and the linear kernel's products
     (``linear_fp32.wg_launches``: 34 in a step's forward, 67 in its
     backward, in the xla steps as in the flash ones);
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
     peak memory and the linear kernel's products (245 forward and 460
     backward a step);
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
     and one BLEEP step in bf16;
 20. analysis: the port's tutorial (``mclstexp_tpu_torch.tutorial``, two
     epochs) on the card: ``train_fold`` (row_shift's shears, three launches
     a step), the embedding sweep, the held-out fold's retrieval and
     prediction file, ``gene_ranking``, the plot (matplotlib is absent
     there: one line says the PNG was not written) and domain clustering;
     ``cluster_predictions`` on the card against the CPU (the same k-means
     labels, equal ARI/NMI) on its prediction and on seed-made domains at
     her2st's width (600 spots x 785 genes), PCA + k-means timed; on a flat
     spectrum at that width scikit-learn's randomized PCA, card against CPU;
 21. shard-eval: a one-rank NCCL group in this process (``make_mesh``):
     ``sharded_retrieve_and_aggregate`` at [serve]'s her2st scale against
     ``retrieve_and_aggregate`` (indices identical, aggregates within 1e-6),
     timed, the group destroyed; then ``torchrun --nproc-per-node=<cards>
     -m``-style ``eval --shard-eval`` on [cli]'s tree and checkpoint with a
     fresh patch cache: the ranks' cooperative pre-cut launches
     extract_patches once per section, the metrics equal [cli]'s ``eval``
     within rtol 1e-6, each rank's world size and rank printed.
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
TF32_FLOPS_PER_S = 495e12  # H100 SXM published dense tf32 tensor-core rate


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
               flash_attention.TF32_SOURCE, flash_attention.TF32_BWD_SOURCE,
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


def _fp32_flash_bound(nbytes, flops):
    """(bound ms, bound_by) of an fp32 flash kernel: the larger of its bytes
    at 3.35 TB/s and its products on the tensor cores, each fp32 product
    three tf32 ones (the 3xTF32 split) at 495 TFLOP/s."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / TF32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _flash_fwd_bound(shape):
    """(bound ms, bound_by, bytes, flops) of the forward at ``shape``: q, k,
    v read and out written once (4*b*h*n*d floats), two products of
    2*b*h*n^2*d flops; bounded as ``_fp32_flash_bound`` says."""
    b, h, n, d = shape
    nbytes = 4 * b * h * n * d * 4
    flops = 4 * b * h * n * n * d
    return (*_fp32_flash_bound(nbytes, flops), nbytes, flops)


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

    def pair():  # as FlashAttention runs it: one split pass for both backward kernels
        o, ll, mm = fa.flash_forward(q, k, v, scale, residuals=True)
        dd = (o * do).sum(-1).contiguous()
        fa.flash_backward(q, k, v, do, ll, mm, dd, scale)

    return (q, k, v, do, l, m, di, scale), pair, library_pair


def _bwd_kernels(shape):
    """(name, kernel, plain version, bound ms, bound_by, bytes, flops) of
    dK/dV and dQ at ``shape``: dK/dV reads q, k, v, dout, l, m, di and
    writes dk, dv (8*b*h*n^2*d flops), dQ writes dq (6*b*h*n^2*d); bounded
    as ``_fp32_flash_bound`` says."""
    from mclstexp_tpu_torch.ops import flash_attention as fa

    b, h, n, d = shape
    out = []
    for name, kernel, plain, n_out, per_flop in (
            ("bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
            ("bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6)):
        nbytes = (4 + n_out) * b * h * n * d * 4 + 3 * b * h * n * 4
        flops = per_flop * b * h * n * n * d
        out.append((name, kernel, plain, *_fp32_flash_bound(nbytes, flops), nbytes, flops))
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

    design, rows, split, ctas = fa.fp32_plan(*BWD_LONG)
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
    log(f"[kernels] flash_attention fp32 {BWD_LONG} plan {design} rows={rows} split={split} "
        f"ctas={ctas}: "
        f"out/l/m within {err:.3e} of the plain version (atol {FLASH_ATOL}); kernel {ms:.4f} ms, "
        f"with residuals {residuals_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA forward "
        f"{library_ms:.4f} ms, kernel / SDPA {ms / library_ms:.3f}, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops / 1e9:.1f} GFLOP), {bound_ms / ms:.1%} of bound "
        f"({flops / ms / 1e9:.1f} TFLOP/s fp32 work)")
    fwd_entry["max_abs_err"] = max(fwd_entry["max_abs_err"], err)
    fwd_entry["long"] = {"shape": list(BWD_LONG), "ms": ms, "residuals_ms": residuals_ms,
                         "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": err,
                         "plan": {"design": design, "rows": rows, "split": split,
                                  "ctas": ctas}}
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
        log(f"[kernels] flash_attention[{name}] fp32 {BWD_LONG} plan {design} rows={rows} "
            f"split={split} ctas={ctas}: max abs err {err:.3e} (atol {FLASH_ATOL}); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops / 1e9:.1f} GFLOP), {bound_ms / ms:.1%} of bound "
            f"({flops / ms / 1e9:.1f} TFLOP/s fp32 work)")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["long"] = {"shape": list(BWD_LONG), "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                         "plan": {"design": design, "rows": rows, "split": split,
                                  "ctas": ctas},
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


LINEAR_STEP = (34, 67)  # HisToGene's products a whole-slide step: forward, backward
HIST2ST_LINEAR_STEP = 245 + 460  # Hist2ST's: 6 passes and their backward


def phase_linear() -> list:
    """[linear] (module docstring, phase 3a): one entry per product
    (forward, dX, dW) with the qkv shape's numbers, (4,096, 3,072, 1,024),
    and every shape's under ``shapes``."""
    import torch

    from mclstexp_tpu_torch.ops import linear as lin
    from mclstexp_tpu_torch.profile_kernels import LINEAR_SHAPES, time_linear

    g = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    products = {"fwd": "", "dx": "_dx", "dw": "_dw"}
    shapes = {name: {} for name in products}
    for m, n, k in LINEAR_SHAPES:
        shape = (m, n, k)
        if lin.linear_plan(*shape) != "warpgroup":
            raise AssertionError(f"linear_plan leaves {shape} on cuBLAS")
        x = torch.randn((m, k), generator=g, device="cuda", requires_grad=True)
        w = torch.randn((n, k), generator=g, device="cuda", requires_grad=True)
        b = torch.randn((n,), generator=g, device="cuda", requires_grad=True)
        dy = torch.randn((m, n), generator=g, device="cuda")

        def run():
            y = lin.linear_fp32(x, w, b)
            return (y.detach(), *torch.autograd.grad(y, (x, w, b), dy))

        before = lin.linear_fp32.wg_launches
        first = run()
        if lin.linear_fp32.wg_launches != before + 3:
            raise AssertionError(f"linear_fp32 {shape}: {lin.linear_fp32.wg_launches - before} "
                                 "products on the kernel, not 3")
        if not all(torch.equal(u, v) for u, v in zip(first, run())):
            raise AssertionError(f"linear_fp32 {shape}: two runs differ")
        del x, w, b, dy, first
        t = time_linear(shape, g)
        text = []
        for name, part in products.items():
            err, lib_err, tf32_err = (t[key + part] for key in (
                "err_kernel", "err_cublas", "err_cublas_tf32"))
            if not err <= 2 * lib_err < tf32_err:
                raise AssertionError(f"linear {name} {shape}: error against float64 {err:.2e}, "
                                     f"cuBLAS fp32 {lib_err:.2e}, TF32 {tf32_err:.2e}; want the "
                                     "kernel within twice cuBLAS fp32's, and TF32 beyond")
            ms = t["kernel" + part]
            shapes[name][str(shape)] = {
                "ms": ms, "bound_ms": t["bound"], "library_ms": t["cublas" + part],
                "library_tf32_ms": t["cublas_tf32" + part], "rel_err": err,
                "library_rel_err": lib_err, "library_tf32_rel_err": tf32_err}
            text.append(f"{name} {ms:.4f} ms ({t['bound'] / ms:.1%} of bound, cuBLAS fp32 "
                        f"{t['cublas' + part]:.4f}, TF32 {t['cublas_tf32' + part]:.4f}; err "
                        f"{err:.1e} / {lib_err:.1e} / {tf32_err:.1e})")
        log(f"[linear] linear_fp32 {shape}: bound {t['bound']:.4f} ms a product; "
            f"{'; '.join(text)}; backward with db {t['backward']:.4f} ms against cuBLAS "
            f"{t['cublas_backward']:.4f} ms; deterministic")
    torch.cuda.empty_cache()
    entries = []
    for name, by_shape in shapes.items():
        head = by_shape[str(LINEAR_SHAPES[1])]
        entries.append({
            "name": f"linear_fp32[{name}]", "route": "cuda",
            "source": "mclstexp_tpu_torch/csrc/linear_tf32.cu", "replaces": None,
            "ms": head["ms"], "plain_ms": head["library_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "operations", "library_ms": head["library_ms"],
            "library_tf32_ms": head["library_tf32_ms"],
            "max_rel_err": max(v["rel_err"] for v in by_shape.values()), "shapes": by_shape})
    return entries


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
    from mclstexp_tpu_torch.ops.linear import linear_fp32
    from mclstexp_tpu_torch.ops.row_shift import row_shift

    for w in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq):
        w.launches = w.segment_launches = w.bf16_launches = w.bf16_segment_launches = 0
        w.wg_launches = 0
    linear_fp32.wg_launches = 0
    row_shift.launches = 0
    row_shift.kernel_launches = dict.fromkeys(row_shift.kernel_launches, 0)


def _train_flash_fold(cfg, sections, resume: bool, mesh=None):
    """train_fold (over ``mesh`` if given) with the counts set to 0 just
    before it and read just after: (state, losses, resume records, (fwd,
    dkv, dq) launches, row_shift launches by layout)."""
    import torch

    from mclstexp_tpu_torch.ops.row_shift import row_shift
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(echo=True)
    _reset_counts()
    state = train_fold(cfg, sections, fold=0, logger=logger, device="cuda", resume=resume,
                       mesh=mesh)
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


def phase_cli_baseline() -> tuple:
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
    ``baseline`` process and the scores it printed."""
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
    return counts["histogene"]["extract_patches"], results["histogene"]


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

    def pair():  # as FlashAttention runs it: one split pass for both backward kernels
        o, ll, mm = fa.flash_forward(q, k, v, scale, residuals=True, segment_ids=seg)
        dd = (o * do).sum(-1).contiguous()
        fa.flash_backward(q, k, v, do, ll, mm, dd, scale, seg)

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
    design, rows, split, ctas = fa.fp32_plan(*shape)
    bounds = {"fwd": _flash_fwd_bound(shape)}
    for name, _, _, bound_ms, bound_by, nbytes, flops in _bwd_kernels(shape):
        bounds[name] = (bound_ms, bound_by, nbytes, flops)
    out_records = {}
    for name, (kernel, unmasked, plain, library) in kernels.items():
        _, _, nbytes, flops = bounds[name]
        nbytes += 4 * n  # the segment ids, read once
        bound_ms, bound_by = _fp32_flash_bound(nbytes, flops)
        ms, plain_ms = timed(kernel), timed(plain, plain=True)
        unmasked_ms = timed(unmasked)
        library_ms = timed(library) if library is not None else None
        log(f"[baselines] {SEG_NAMES[name]} fp32 {shape} {kind} ids"
            f"{'' if real is None else f' ({real} real rows)'} plan {design} rows={rows} "
            f"split={split} "
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
                             "plan": {"design": design, "rows": rows, "split": split,
                                      "ctas": ctas},
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
                      "source": "mclstexp_tpu_torch/csrc/" + (  # fp32_plan's design at SEG_CASES
                          "flash_attention_tf32.cu" if name == "fwd"
                          else "flash_attention_bwd_tf32.cu"),
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
    HisToGene fold (the main path) and of the THItoGene fold, and the linear
    kernel's products in a whole-slide step (forward, backward)."""
    import dataclasses

    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.ops import flash_attention as fa
    from mclstexp_tpu_torch.ops import linear as lin

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
    # the linear kernel's products in one step's forward and backward
    lin.linear_fp32.wg_launches = 0
    loss = trainer.slide_loss(flash.model, cfg, batch,
                              augment.reseed(torch.Generator(device="cuda"), 0, 1))
    linear = [lin.linear_fp32.wg_launches]
    loss.backward()
    linear.append(lin.linear_fp32.wg_launches - linear[0])
    flash.model.zero_grad(set_to_none=True)
    del loss
    if tuple(linear) != LINEAR_STEP:
        raise AssertionError(f"whole-slide step: {linear} linear products on the kernel "
                             f"(forward, backward), not {LINEAR_STEP}")
    _reset_counts()
    for name in ("xla", "flash", "flash", "xla"):
        torch.cuda.reset_peak_memory_stats()
        whole_times[name].append(_slide_step_ms(xla if name == "xla" else flash, cfg, batch,
                                                n=2))
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    # the fp32 warpgroup kernels (fp32_plan at (1, 16, 4096, 64)): 8 launches
    # of each a step, 6 flash steps (each timing's warm-up and 2)
    wg = tuple(w.wg_launches for w in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq))
    if wg != (6 * 8,) * 3 or _flash_counts() != wg:
        raise AssertionError(f"whole-slide steps: warpgroup launches {wg}, launches "
                             f"{_flash_counts()}; expected 48 of each (8 per step)")
    steps_linear = lin.linear_fp32.wg_launches
    if steps_linear != 12 * sum(LINEAR_STEP):
        raise AssertionError(f"whole-slide steps: {steps_linear} linear products on the "
                             f"kernel in 12 steps, not {12 * sum(LINEAR_STEP)}")
    log(f"[baselines] HisToGene whole-slide step, {n} spots padded to {len(batch['mask'])} "
        f"(attention (1, 16, 4096, 64) per layer, plan {fa.fp32_plan(1, 16, 4096, 64)}), ms "
        f"per slide step (xla, flash, flash, xla; 2 steps each): xla {whole_times['xla']}, "
        f"flash {whole_times['flash']}; warpgroup launches forward/dK-dV/dQ {wg} in 6 steps "
        f"(8 per step); linear products on the kernel {linear[0]} forward + {linear[1]} "
        f"backward a step, {steps_linear} in the 12 timed steps; peak memory (both models and "
        f"their Adam state resident) xla "
        f"{peaks['xla']:.1f} GiB, flash {peaks['flash']:.1f} GiB, on {card_line()}")
    del xla, flash, batch
    torch.cuda.empty_cache()
    return counts, tcounts, linear


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
    from mclstexp_tpu_torch.ops.linear import linear_fp32

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
    linear_fp32.wg_launches = 0
    ms = [_slide_step_ms(state, cfg, batch, n=2)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if linear_fp32.wg_launches != 3 * HIST2ST_LINEAR_STEP:
        raise AssertionError(f"Hist2ST whole-slide steps: {linear_fp32.wg_launches} linear "
                             f"products on the kernel in 3 steps, not {3 * HIST2ST_LINEAR_STEP}")
    log(f"[hist2st] Hist2ST whole-slide step, {whole.num_spots} spots padded to "
        f"{len(batch['mask'])} (6 passes of 8 layers of attention (1, 16, 4096, 64) with ids), "
        f"flash: {ms} ms per slide step (2 steps after one), {HIST2ST_LINEAR_STEP} linear "
        f"products a step on the kernel; peak memory {peak:.1f} GiB (the "
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


BLOBS = (600, 785, 6)  # her2st width: spots, genes, domains


def _blobs(seed: int = 15):
    """Seed-made domains at her2st's width: 6 centers 8 apart per gene, unit
    noise; labels "domain<k>", every 50th spot "undetermined"."""
    import numpy as np

    n, g, k = BLOBS
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n)
    x = (8.0 * rng.normal(size=(k, g))[y] + rng.normal(size=(n, g))).astype(np.float32)
    labels = np.array([f"domain{v}" for v in y], dtype=object)
    labels[::50] = "undetermined"
    return x, labels


def phase_analysis() -> dict:
    """[analysis] the port's tutorial on the card (two epochs: training with
    row_shift's Paeth shears, the embedding sweep, the fold's retrieval and
    prediction file, the gene ranking, the plot where matplotlib is
    importable, domain clustering); the ranking again on its prediction;
    ``cluster_predictions`` on the card against the CPU on the same input
    (the same k-means labels, equal ARI and NMI), then on seed-made domains
    at her2st's width (600 spots x 785 genes), with the card's time for PCA
    and k-means, and on a flat spectrum at that width, where the PCA is
    scikit-learn's randomized solver: its scores on the card within 1e-3 of
    the largest of the CPU's, the clustering equal. Returns row_shift's
    launches in the tutorial."""
    import shutil

    import numpy as np
    import torch

    from mclstexp_tpu_torch import tutorial
    from mclstexp_tpu_torch.data.pipeline import num_train_steps
    from mclstexp_tpu_torch.infer import cluster, metrics
    from mclstexp_tpu_torch.ops.row_shift import row_shift

    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(repo, "build", "chip_smoke", "tutorial")
    shutil.rmtree(out_dir, ignore_errors=True)
    _reset_counts()
    t0 = time.perf_counter()
    out = tutorial.main(out_dir, max_epochs=2, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(row_shift.kernel_launches)
    steps = 2 * num_train_steps(2 * 64, 32)  # two 64-spot training sections, batch 32
    if launches != _shear_launches(steps):
        raise AssertionError(f"the tutorial's {steps} steps launched row_shift {launches}; "
                             f"the Paeth rotation takes {_shear_launches(steps)}")
    pred, ranking = out["pred"], out["ranking"]
    if pred.shape != (64, 32) or not np.isfinite(pred).all() or \
            not all(math.isfinite(v) for v in out["metrics"].values()):
        raise AssertionError(f"tutorial: prediction {pred.shape}, metrics {out['metrics']}")
    logp = np.asarray(ranking["mean_neglog10_p"])
    finite = logp[np.isfinite(logp)]
    if sorted(ranking["gene"]) != sorted(f"GENE{i}" for i in range(32)) or \
            not (np.diff(finite) <= 0).all() or not np.isnan(logp[len(finite):]).all():
        raise AssertionError(f"gene_ranking of the tutorial's prediction: {ranking}")
    png = ("written: " + out["png"]) if out["png"] else \
        "not written (matplotlib is not importable here; the rest of the run went on)"
    log(f"[analysis] tutorial on the card, 2 epochs ({steps} steps): {seconds:.2f} s; fold "
        f"metrics {out['metrics']}; row_shift {launches}; top genes {ranking['gene'][:5]}; "
        f"PNG {png}")

    labels = out["labels"]
    card = metrics.cluster_predictions(pred, labels, device="cuda")
    host = metrics.cluster_predictions(pred, labels, device="cpu")
    card_labels, _ = cluster.kmeans(cluster.pca(pred, 9, 0, "cuda"), 2, 0, "cuda")
    host_labels, _ = cluster.kmeans(cluster.pca(pred, 9, 0, "cpu"), 2, 0, "cpu")
    if card != host or not (card_labels == host_labels).all():
        raise AssertionError(f"tutorial clustering: card {card}, CPU {host}")
    log(f"[analysis] tutorial clustering on the card {card}, equal to the CPU's "
        f"(k-means labels identical)")

    x, labels = _blobs()
    keep = labels != "undetermined"
    card = metrics.cluster_predictions(x, labels, device="cuda")
    host = metrics.cluster_predictions(x, labels, device="cpu")
    times = []
    for _ in range(6):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_labels, _ = cluster.kmeans(cluster.pca(x[keep], 9, 0, "cuda"), BLOBS[2], 0, "cuda")
        times.append((time.perf_counter() - t0) * 1e3)
    host_labels, _ = cluster.kmeans(cluster.pca(x[keep], 9, 0, "cpu"), BLOBS[2], 0, "cpu")
    if card != host or not (card_labels == host_labels).all() or card["ari"] != 1.0:
        raise AssertionError(f"domains at her2st width: card {card}, CPU {host}")
    log(f"[analysis] {BLOBS[0]} spots x {BLOBS[1]} genes, {BLOBS[2]} domains "
        f"({int(keep.sum())} labelled): {card}, equal to the CPU's; PCA (9 components, the "
        f"{cluster.pca_solver(x[keep].shape, 9)} solver in float32) + k-means on the card "
        f"{sorted(times[1:])[2]:.2f} ms (median of 5; {', '.join(f'{t:.2f}' for t in times)})")

    # a flat spectrum (unit noise around weak domain centers): scikit-learn's
    # randomized solver, whose components are not the exact ones here
    rs = np.random.RandomState(3)
    y = rs.randint(0, BLOBS[2], size=BLOBS[0])
    flat = (0.3 * rs.normal(size=(BLOBS[2], BLOBS[1]))[y]
            + rs.normal(size=BLOBS[:2])).astype(np.float32)
    flat_labels = np.array([f"domain{v}" for v in y], dtype=object)
    solver = cluster.pca_solver(flat.shape, 9)
    host_pca = cluster.pca(flat, 9, 0, "cpu").numpy()
    pca_ms = []
    for _ in range(6):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_pca = cluster.pca(flat, 9, 0, "cuda").cpu().numpy()
        pca_ms.append((time.perf_counter() - t0) * 1e3)
    err = float(np.abs(card_pca - host_pca).max() / np.abs(host_pca).max())
    card = metrics.cluster_predictions(flat, flat_labels, device="cuda")
    host = metrics.cluster_predictions(flat, flat_labels, device="cpu")
    if solver != "randomized" or card_pca.dtype != np.float32 or not err <= 1e-3 or \
            card != host:
        raise AssertionError(f"flat spectrum: solver {solver}, card PCA {err:.2e} of the "
                             f"largest score from the CPU's, clustering {card} vs {host}")
    log(f"[analysis] flat spectrum ({BLOBS[0]} x {BLOBS[1]}, domains of scale 0.3 over unit "
        f"noise): randomized PCA (10 oversamples, 7 LU-normalized power iterations, float32) "
        f"on the card within {err:.2e} of the largest score from the CPU's (allowed 1e-3), "
        f"{sorted(pca_ms[1:])[2]:.2f} ms (median of 5; {', '.join(f'{t:.2f}' for t in pca_ms)}"
        f"); cluster_predictions {card}, equal to the CPU's")
    return launches


def phase_shard_eval() -> int:
    """[shard-eval] the multi-process eval path on the card: in this process
    a one-rank NCCL group (``make_mesh``), ``sharded_retrieve_and_aggregate``
    at [serve]'s her2st scale (568 queries, 15,499 keys of which 14,931
    active, K=200, 256 / 785 wide) against ``retrieve_and_aggregate`` on the
    same inputs (indices identical, aggregates within 1e-6), each timed; the
    group destroyed. Then ``eval --shard-eval`` under ``torchrun`` (one
    process per card) on [cli]'s tree and checkpoint with a fresh patch
    cache, so the cooperative pre-cut cuts every section with the
    extract_patches kernel: its metrics against [cli]'s ``eval`` within rtol
    1e-6. Returns the extract_patches launches of the torchrun job."""
    import subprocess

    import numpy as np
    import torch

    from mclstexp_tpu_torch.ops import retrieval
    from mclstexp_tpu_torch.ops.retrieval_sharded import sharded_retrieve_and_aggregate
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.parallel.mesh import make_mesh

    nq, nk, k = 568, 15499, 200
    rng = np.random.default_rng(16)
    keys = rng.normal(size=(nk, 256)).astype(np.float32)
    expr = rng.normal(size=(nk, 785)).astype(np.float32)
    queries = rng.normal(size=(nq, 256)).astype(np.float32)
    mask = np.ones(nk, bool)
    mask[:nq] = False  # the held-out section, as [serve]'s fold
    mesh = make_mesh(device="cuda")
    try:
        backend = torch.distributed.get_backend()
        # one query chunk of the fold's size: the score product has the
        # dense path's shape, so the two select on the same scores
        chunk = dict(query_chunk=nq)
        times = {"sharded": [], "dense": []}
        for _ in range(6):  # the first of each is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, idx, emb, pred = sharded_retrieve_and_aggregate(
                keys, expr, queries, k, mesh, key_mask=mask, return_matches=True,
                device="cuda", **chunk)
            times["sharded"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            want_emb, want_pred = retrieval.retrieve_and_aggregate(
                keys, expr, queries, k, key_mask=mask, device="cuda")
            times["dense"].append((time.perf_counter() - t0) * 1e3)
        _, want_idx = retrieval.find_matches(torch.from_numpy(keys).cuda(),
                                             torch.from_numpy(queries).cuda(), k,
                                             key_mask=torch.from_numpy(mask).cuda())
        err = max(float(np.abs(emb - want_emb).max()), float(np.abs(pred - want_pred).max()))
        if not np.array_equal(idx, want_idx.cpu().numpy()) or not err <= 1e-6:
            raise AssertionError(f"sharded retrieval: indices equal "
                                 f"{np.array_equal(idx, want_idx.cpu().numpy())}, aggregates "
                                 f"max abs diff {err}")
    finally:
        distributed.shutdown()
    med = {name: sorted(t[1:])[2] for name, t in times.items()}
    log(f"[shard-eval] sharded_retrieve_and_aggregate over a one-rank {backend} group: "
        f"{nq} queries x {int(mask.sum())} active keys of {nk}, K={k}: indices identical to "
        f"retrieve_and_aggregate's, aggregates within {err:.1e}; {med['sharded']:.2f} ms "
        f"sharded, {med['dense']:.2f} ms dense (host arrays in and out, medians of 5: "
        f"{', '.join(f'{t:.2f}' for t in times['sharded'])} / "
        f"{', '.join(f'{t:.2f}' for t in times['dense'])}); group destroyed: "
        f"{not distributed.is_initialized()}")

    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke", "cli")
    child = os.path.join(work, "cli_child.py")
    with open(child, "w") as f:
        f.write(_CLI_CHILD)
    flags = ["--dataset", "her2st", "--data-root", os.path.join(work, "her2st"),
             "--gene-panel", os.path.join(work, "panel", "her2st_hvg_panel.npy")]
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()  # the job's processes share the card with this one
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", child, "eval", "--fold", "0", "--shard-eval",
             "--patch-cache", "patch_cache_shard", "--json", "shard.json"] + flags,
            capture_output=True, text=True, env=_child_env(repo), timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun eval --shard-eval exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        ranks = [line for line in proc.stderr.splitlines() if "eval --shard-eval: rank" in line]
        counts = [json.loads(line) for line in proc.stdout.splitlines()
                  if line.startswith('{"row_shift"')]
        host, sharded = _json_file("eval.json"), _json_file("shard.json")
    finally:
        os.chdir(cwd)
    launches = sum(c["extract_patches"] for c in counts)
    sections = len(os.listdir(os.path.join(work, "her2st", "ST-cnts")))
    if len(ranks) != world or len(counts) != world or launches != sections:
        raise AssertionError(f"torchrun eval --shard-eval: ranks {ranks}, launch counts "
                             f"{counts}; the pre-cut cuts each of {sections} sections once")
    for key, v in host["avg"].items():
        if not math.isclose(sharded["avg"][key], v, rel_tol=1e-6):
            raise AssertionError(f"eval --shard-eval {key} {sharded['avg'][key]} vs eval {v}")
    log(f"[shard-eval] torchrun --nproc-per-node={world} eval --shard-eval (world size "
        f"{world}; {'; '.join(r.split(': ', 1)[1] for r in ranks)}): {seconds:.2f} s; "
        f"extract_patches {launches} in the cooperative pre-cut of {sections} sections on "
        f"a fresh cache; metrics {sharded['avg']} equal to [cli]'s eval within rtol 1e-6")
    return launches


def _state_diff(got: dict, want: dict) -> dict:
    """Two state dicts apart: bit-equal or not, the largest |difference| of
    any parameter element (Adam bounds it by 2 lr a step), the largest
    running-statistic difference relative to its tensor's largest magnitude
    (with the tensor's name), and the share of parameter elements within
    1e-5 of their tensor's largest magnitude."""
    import torch

    out = dict(equal=True, param=0.0, stat=0.0, stat_name=None, close=0.0)
    close = total = 0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        g = got[k]
        out["equal"] = out["equal"] and torch.equal(g, w)
        err = (g.double() - w.double()).abs()
        scale = max(float(w.abs().max()), 1e-30)
        if k.endswith(("running_mean", "running_var")):
            if float(err.max()) / scale >= out["stat"]:
                out["stat"], out["stat_name"] = float(err.max()) / scale, k
        else:
            out["param"] = max(out["param"], float(err.max()))
            close += int((err <= 1e-5 * scale).sum())
            total += w.numel()
    out["close"] = close / max(total, 1)
    return out


def _check_state_diff(what: str, diff: dict, lr: float, steps: int,
                      stat_rtol: float) -> None:
    if not (diff["param"] <= 2 * lr * steps and diff["stat"] <= stat_rtol):
        raise AssertionError(f"{what}: parameters {diff['param']:.3e} apart (bound 2 lr a "
                             f"step {2 * lr * steps:.1e}), running statistics "
                             f"{diff['stat']:.3e} of their largest magnitude apart "
                             f"({diff['stat_name']}; allowed {stat_rtol})")


def _diff_text(diff: dict, lr: float, steps: int, stat_rtol: float) -> str:
    return (f"bit-equal: {diff['equal']}; largest parameter difference {diff['param']:.3e} "
            f"(bound 2 lr a step {2 * lr * steps:.1e}), {100 * diff['close']:.3f}% of "
            f"parameter elements within 1e-5 of their tensor's largest magnitude; running "
            f"statistics within {diff['stat']:.3e} of their largest magnitude "
            f"({diff['stat_name']}; allowed {stat_rtol})")


def _one_step_grads(state, run) -> tuple:
    """(loss, {parameter: gradient}) of ``run(state)``, one step of a train
    step on ``state``, whose optimizer is replaced by SGD at lr 0 so that
    the gradients stay on the unchanged parameters."""
    import torch

    from mclstexp_tpu_torch.train.state import TrainState

    model = state.model
    loss = float(run(TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))))
    return loss, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _fp64_grads(model, forward) -> dict:
    """The parameter gradients of ``forward(twin)``, a loss, where ``twin``
    is a float64 copy of ``model`` in train mode."""
    import copy

    twin = copy.deepcopy(model).double().train()
    forward(twin).backward()
    return {n: p.grad for n, p in twin.named_parameters() if p.grad is not None}


def _xent64(logits, targets):
    """Soft-target cross-entropy in float64, both directions averaged."""
    import torch

    def one(lg, tg):
        return -(tg * torch.log_softmax(lg, dim=-1)).sum(dim=-1).mean()

    return (one(logits, targets) + one(logits.T, targets.T)) / 2.0


def _check_grads(what: str, got: tuple, want: tuple, exact) -> str:
    """The group's (loss, gradients) against the run without a group: the
    loss within 1e-6, every tensor within ``DP_GRAD_RTOL`` of its largest
    magnitude, or else held to ``exact()``, a float64 evaluation of the
    step: its one-process float32 gradient then ill-conditioned (farther
    than ``DP_GRAD_ILL`` from the float64 one: a sum that cancels, such as
    a norm's bias or the weight of the convolution before it, over channels
    whose spread is small against their mean, on these near-uniform
    synthetic patches; cuDNN's algorithm, which the memory free for its
    workspace picks, moves such sums by 1e-3 to 1e-2), and the group's no
    farther from the float64 one than ``DP_GRAD_RTOL`` or
    ``DP_GRAD_ILL_FACTOR`` times the one-process distance, whichever is
    larger: such a sum's float32 error changes by several times with the
    order of its terms (measured 2.1 times on the CPU,
    tests/test_torch_port_dp.py, and 4.4 to 8.1 times on the card). A
    gradient N times too large or a missing term lies ~100% from float64.
    Returns the log's text."""
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    if set(got[1]) != set(want[1]) or not loss_err <= 1e-6:
        raise AssertionError(f"{what}: loss {got[0]} against {want[0]}")
    worst, worst_name, ill = 0.0, None, {}
    fp64 = None
    for name, w in want[1].items():
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[1][name] - w).abs().max()) / scale
        if err <= DP_GRAD_RTOL:
            if err >= worst:
                worst, worst_name = err, name
            continue
        fp64 = fp64 or exact()
        one = float((w.double() - fp64[name]).abs().max()) / scale
        grp = float((got[1][name].double() - fp64[name]).abs().max()) / scale
        ill[name] = (err, one, grp)
    bad = {k: v for k, v in ill.items()
           if not (v[1] > DP_GRAD_ILL and v[2] <= max(DP_GRAD_ILL_FACTOR * v[1], DP_GRAD_RTOL))}
    if bad:
        worst_bad = sorted((bad or ill).items(), key=lambda kv: -kv[1][2])[:8]
        raise AssertionError(f"{what}: {len(ill)} of {len(want[1])} gradient tensors apart, "
                             f"{len(bad)} beyond the float64 bounds, each (apart from the run "
                             f"without a group; that run, the group's from a float64 "
                             f"evaluation): {worst_bad}")
    ill = {k: (round(v[1], 6), round(v[2], 6)) for k, v in ill.items()}
    return (f"one step from the same weights and batch (TF32 off): loss {got[0]:.6f} against "
            f"{want[0]:.6f}; {len(want[1]) - len(ill)} gradient tensors within {worst:.3e} of "
            f"their largest magnitude ({worst_name}; allowed {DP_GRAD_RTOL}); "
            f"{len(ill)} farther, each (without a group, the group) from a float64 evaluation: "
            f"{ill}")


def _dp_step_ms(cfg, state, batch, draws, shard, n: int = 3) -> float:
    """``_step_ms`` of the data-parallel step over ``shard``'s group."""
    import torch

    from mclstexp_tpu_torch.train.step import make_train_step

    step = make_train_step("st", rot_impl=cfg.train.rot_impl)
    for _ in range(2):
        step(state, batch, draws, None, shard)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss = step(state, batch, draws, None, shard)
    torch.cuda.synchronize()
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite loss in the timed data-parallel steps")
    return (time.perf_counter() - t0) / n * 1e3


# A data-parallel run at world 1 against the run without a group. One step
# from the same weights, batch and draws, TF32 off: the same loss and every
# gradient tensor within DP_GRAD_RTOL of its largest magnitude (the global
# norm's fp32 statistics round otherwise than cuDNN's). Whole folds part
# further at every step, Adam turning a gradient at the rounding floor into
# a step anywhere in (-lr, lr) and cuDNN's TF32 convolutions rounding the
# next inputs at 2^-11: the flagship folds ([train-dp], 4 steps; [cli-dp]'s
# train, 14) held to losses within rtol DP_LOSS_RTOL / _LONG, every
# parameter within 2 lr a step, running statistics within DP_STAT_RTOL /
# _LONG of each tensor's largest magnitude.
DP_GRAD_RTOL = 1e-3
DP_GRAD_ILL = 1e-4  # a float32 gradient this far from float64 is ill-conditioned
DP_GRAD_ILL_FACTOR = 10.0
DP_LOSS_RTOL = 2e-3
DP_STAT_RTOL = 2e-2
DP_LOSS_RTOL_LONG = 5e-3
DP_STAT_RTOL_LONG = 1e-1
DP_NORM_RTOL = 1e-4  # one forward's outputs and statistics, TF32 off


def phase_train_dp(fcfg, sections, steps):
    """[train-dp] [train-flash]'s fold (her2st widths, "flash") under a
    one-rank NCCL group (``make_mesh``): the data-parallel step (the global
    batch norm, ``symmetric_infonce_gathered``, the gradient average),
    launching row_shift's shears and the three flash kernels as
    [train-flash] does; its losses against the same fold without a group
    (rtol ``DP_LOSS_RTOL``: the runs part a little more at every step, see
    the constants) and its state (every parameter element within 2 lr a step: Adam's step
    is at most lr, whatever a gradient's rounding; the running statistics
    within ``DP_STAT_RTOL`` of each tensor's largest magnitude; the share of
    parameters within 1e-5 logged), whether they are bit-equal; the global
    norm alone, one train-mode forward of the image tower against cuDNN's
    norms from the same weights (TF32 off, within ``DP_NORM_RTOL``); and
    one step's loss and gradients against the step without a group from
    the same weights, batch and draws (TF32 off, within ``DP_GRAD_RTOL``);
    and ms/step against the step without a group (plain, dp, dp, plain).
    Returns the launches of the data-parallel fold: ((forward, dK/dV, dQ),
    row_shift's by kernel)."""
    import copy
    import dataclasses

    import torch

    from mclstexp_tpu_torch.models.image.common import BatchNormT, global_batch_stats
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.parallel.mesh import make_mesh
    from mclstexp_tpu_torch.train.state import create_train_state
    from mclstexp_tpu_torch.train.step import Shard, make_train_step

    root = os.path.dirname(os.path.abspath(__file__))

    def cfg_in(tag):
        return fcfg.replace(train=dataclasses.replace(fcfg.train, checkpoint_dir=os.path.join(
            root, "build", "chip_smoke", tag)))

    ref, ref_losses, _, _, _ = _train_flash_fold(cfg_in("model_result_nogroup"), sections,
                                                 resume=False)
    mesh = make_mesh(device="cuda")
    try:
        backend = torch.distributed.get_backend()
        t0 = time.perf_counter()
        state, losses, _, counts, shifts = _train_flash_fold(cfg_in("model_result_dp"),
                                                             sections, resume=False, mesh=mesh)
        seconds = time.perf_counter() - t0
        want = fcfg.model.head_layers * steps
        if state.step != steps or counts != (want, want, want) or \
                shifts != _shear_launches(steps):
            raise AssertionError(f"data-parallel fold: {state.step} steps, flash launches "
                                 f"{counts}, row_shift {shifts}")
        bit_losses = losses == ref_losses
        for a, b in zip(losses, ref_losses):
            if not math.isclose(a, b, rel_tol=DP_LOSS_RTOL):
                raise AssertionError(f"data-parallel losses {losses} against {ref_losses}")
        diff = _state_diff(state.model.state_dict(), ref.model.state_dict())
        _check_state_diff("[train-dp] the data-parallel fold", diff, fcfg.train.lr, steps,
                          DP_STAT_RTOL)
        log(f"[train-dp] train_fold over a one-rank {backend} group (make_mesh), "
            f"attn_backend='flash': {steps} steps in {seconds:.1f} s incl. set-up; launches "
            f"forward/dK-dV/dQ {counts}, row_shift {shifts}; losses {losses} against "
            f"{ref_losses} without a group (rtol {DP_LOSS_RTOL}; bit-equal: {bit_losses}); "
            f"state {_diff_text(diff, fcfg.train.lr, steps, DP_STAT_RTOL)}")

        # the global norm alone: one train-mode forward of the image tower
        # from the same weights on the same images, with and without it
        batch, draws = _step_batch(fcfg, sections)
        group = torch.distributed.group.WORLD
        images = augment.train_augment_inline(batch["image_u8"], draws)
        towers = [copy.deepcopy(ref.model.tower).train() for _ in range(2)]
        with _no_tf32(), torch.no_grad():
            plain_feats = towers[0](images)
            with global_batch_stats(towers[1], group):
                group_feats = towers[1](images)
        out_err = float((group_feats - plain_feats).abs().max()) / float(
            plain_feats.abs().max())
        n_norms = sum(isinstance(m, BatchNormT) for m in towers[0].modules())
        stats = _state_diff(towers[1].state_dict(), towers[0].state_dict())
        if not (out_err <= DP_NORM_RTOL and stats["stat"] <= DP_NORM_RTOL):
            raise AssertionError(f"[train-dp] the global batch norm: features {out_err:.3e}, "
                                 f"running statistics {stats['stat']:.3e} "
                                 f"({stats['stat_name']}) of their largest magnitude from "
                                 f"cuDNN's (allowed {DP_NORM_RTOL})")
        log(f"[train-dp] densenet121's {n_norms} batch norms over the group against cuDNN's, one "
            f"train-mode forward of B={len(images)} (TF32 off): features within {out_err:.3e} "
            f"of their largest magnitude, running statistics within {stats['stat']:.3e} "
            f"({stats['stat_name']}; allowed {DP_NORM_RTOL}); bit-equal: {stats['equal']}")
        del towers, plain_feats, group_feats
        n = fcfg.train.batch_size
        shard = Shard(group, slice(0, n), n, replicated=False)
        step = make_train_step("st", rot_impl=fcfg.train.rot_impl)
        with _no_tf32():
            runs = [_one_step_grads(create_train_state(fcfg.model, fcfg.train, "cuda"),
                                    lambda st, sh=sh: step(st, batch, draws, None, sh))
                    for sh in (None, shard)]

        def exact():  # the step in float64 ("xla" attention: the kernels are fp32)
            twin = create_train_state(dataclasses.replace(fcfg.model, attn_backend="xla"),
                                      fcfg.train, "cuda").model
            images = augment.train_augment_inline(batch["image_u8"], draws).double()

            def forward(m):
                image, spot = m({"image": images, "expression": batch["expression"].double(),
                                 "position": batch["position"]})
                return _xent64(spot @ image.T / fcfg.model.temperature,
                               torch.eye(n, dtype=torch.float64, device="cuda"))

            return _fp64_grads(twin, forward)

        with _no_tf32():
            text = _check_grads("[train-dp] one step", runs[1], runs[0], exact)
        log(f"[train-dp] the data-parallel step at B={n}: {text}")
        del runs
        times = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            if name == "plain":
                times[name].append(_step_ms(fcfg, ref, batch, draws, n=3))
            else:
                times[name].append(_dp_step_ms(fcfg, state, batch, draws, shard))
        log(f"[train-dp] ms/step at B={n} (plain, dp, dp, plain; 3 steps each): plain "
            f"{times['plain']}, data-parallel at world 1 {times['dp']} on {card_line()}")
    except BaseException:
        distributed.shutdown()
        raise
    del state, ref
    torch.cuda.empty_cache()
    return counts, shifts


RING_NS = (128, 4096)  # the flagship batch; a mega-slide's sequence
RING_BLOCKS = 4  # the block merge's S in one process
RING_ATOL = 2e-5  # outputs against dense attention
RING_GRAD_RTOL = 1e-4  # of each gradient tensor's largest magnitude


def _attention_with_grads(fn, q, k, v, g):
    """fn(q, k, v) and its q, k, v gradients for the upstream ``g``."""
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(g)
    return out.detach(), (q.grad, k.grad, v.grad)


def _pair_ms(fn, q, k, v, g, n: int = 5) -> float:
    """Event ms of one forward and backward of fn (after one warm-up)."""
    import torch

    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    fn(q, k, v).backward(g)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(q, k, v).backward(g)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _check_attention(what, got, want):
    """Output within RING_ATOL, each gradient within RING_GRAD_RTOL of its
    tensor's largest magnitude; returns the log's text."""
    out_err = float((got[0] - want[0]).abs().max())
    grad_errs = [float((a - b).abs().max()) / float(b.abs().max())
                 for a, b in zip(got[1], want[1])]
    if not (out_err <= RING_ATOL and max(grad_errs) <= RING_GRAD_RTOL):
        raise AssertionError(f"[ring-tp] {what}: output {out_err:.3e} from dense (allowed "
                             f"{RING_ATOL}), dq/dk/dv {grad_errs} of their largest magnitude "
                             f"(allowed {RING_GRAD_RTOL})")
    return (f"output within {out_err:.3e}, dq/dk/dv within "
            f"{', '.join(f'{e:.3e}' for e in grad_errs)} of their largest magnitude")


def _check_spot_grads(got, want, xla_model, img_emb, batch) -> str:
    """The ring's spot-tower gradients against the "xla" model's: each tensor
    within GRAD_RTOL of its largest magnitude, or else held to a float64
    evaluation (the "xla" twin in float64, the loss in float64): no farther
    from it than DP_GRAD_ILL_FACTOR times the "xla" gradient's distance
    (the softmax backward's rowsum cancels in a peaked row, and the ring
    forms it as rowsum(dout * out), the plain backward as sum(p * dp));
    returns the log's text."""
    import copy

    import torch

    if set(got) != set(want) or not any("spot_encoder" in k for k in got):
        raise AssertionError(f"[ring-tp] spot-tower gradients differ in their parameters: "
                             f"{sorted(got)}")
    worst, worst_name, ill, exact = 0.0, None, {}, None
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max()) / scale
        if err <= GRAD_RTOL:
            if err >= worst:
                worst, worst_name = err, name
            continue
        if exact is None:
            twin = copy.deepcopy(xla_model).double().train()
            spot = twin.encode_spots(batch["expression"].double(), batch["position"])
            n = len(spot)
            _xent64(spot @ img_emb.double().T / twin.config.temperature,
                    torch.eye(n, dtype=torch.float64, device=spot.device)).backward()
            exact = {k: p.grad for k, p in twin.named_parameters() if p.grad is not None}
        plain = float((w.double() - exact[name]).abs().max()) / scale
        mine = float((got[name].double() - exact[name]).abs().max()) / scale
        ill[name] = (round(err, 6), round(plain, 6), round(mine, 6))
        if not mine <= max(DP_GRAD_ILL_FACTOR * plain, GRAD_RTOL):
            raise AssertionError(f"[ring-tp] {name}: ring vs xla gradient {err:.3e} of its "
                                 f"largest magnitude apart; from float64 xla {plain:.3e}, ring "
                                 f"{mine:.3e} (allowed {DP_GRAD_ILL_FACTOR} x xla's)")
    return (f"{len(want) - len(ill)} of {len(want)} tensors ring vs xla within {worst:.3e} of "
            f"their largest magnitude ({worst_name}; allowed {GRAD_RTOL}); the others, each "
            f"(ring vs xla; xla, ring from a float64 evaluation): {ill}")


def _mesh_step_ms(cfg, state, batch, draws, shard, mesh, n: int = 3) -> float:
    """``_dp_step_ms`` with the step inside ``active_mesh(mesh)``."""
    from mclstexp_tpu_torch.parallel.mesh import active_mesh

    with active_mesh(mesh):
        return _dp_step_ms(cfg, state, batch, draws, shard, n)


def _mesh_steps(cfg, state, batch, draws, shard, mesh, steps: int = 2):
    """``steps`` data-parallel steps inside ``active_mesh(mesh)`` with the
    counts set to 0 just before them and read just after: (losses, (fwd,
    dkv, dq) launches, row_shift launches by kernel, peak GiB)."""
    import torch

    from mclstexp_tpu_torch.ops.row_shift import row_shift
    from mclstexp_tpu_torch.parallel.mesh import active_mesh
    from mclstexp_tpu_torch.train.step import make_train_step

    step = make_train_step("st", rot_impl=cfg.train.rot_impl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with active_mesh(mesh):
        losses = [float(step(state, batch, draws, None, shard)) for _ in range(steps)]
    torch.cuda.synchronize()
    counts, shifts = _flash_counts(), dict(row_shift.kernel_launches)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return losses, counts, shifts, torch.cuda.max_memory_allocated() / 2**30


def phase_ring_tp(fcfg, sections) -> dict:
    """[ring-tp] the sequence- and tensor-parallel paths over [train-dp]'s
    one-rank NCCL group (the card's machine has one card: a ring of one
    rank, a "model" axis of one). (a) ``ring_self_attention`` at the spot
    tower's (n, 8, 64), n = 128 and 4,096, forward and backward against
    ``dense_reference_attention`` (TF32 off: outputs within RING_ATOL, each
    gradient within RING_GRAD_RTOL of its largest magnitude); (b) the block
    merge over RING_BLOCKS blocks of one sequence at n = 4,096
    (``blockwise_self_attention``, the rotation by indexing) against the
    same; the ring's, the merge's, dense attention's and the fp32 flash
    pair's ms (forward and backward, events); (c) the flagship step (her2st
    widths, B = 128, the Paeth shears) under a (1, 1) ("data", "seq") mesh
    with attn_backend "ring" (2 steps: row_shift's shears, no flash
    launch; its spot-tower gradients against "xla", ``_check_spot_grads``) and
    under a (1, 1) ("data", "model") mesh after ``shard_train_state`` with
    "flash" (2 steps: the shears and head_layers flash launches of each
    kernel a step; at model 1 ``shard_params`` replicates, as JAX's does,
    so this is [train-dp]'s step: the same first loss), each beside
    [train-dp]'s step (dp, ring, tp, tp, ring, dp), with peak memory.
    Returns {"ring": row_shift launches, "tp": (flash launches, row_shift
    launches)}."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.ops.flash_attention import flash_attention
    from mclstexp_tpu_torch.parallel import ring_attention as ring
    from mclstexp_tpu_torch.parallel import tp
    from mclstexp_tpu_torch.parallel.mesh import active_mesh, make_mesh
    from mclstexp_tpu_torch.train.state import create_train_state
    from mclstexp_tpu_torch.train.step import batch_shard

    t_phase = time.perf_counter()
    group = torch.distributed.group.WORLD
    m = fcfg.model
    h, d = m.heads_num, m.heads_dim
    g = torch.Generator(device="cuda").manual_seed(17)
    for n in RING_NS:
        q, k, v, up = (torch.randn((n, h, d), generator=g, device="cuda") for _ in range(4))
        with _no_tf32():
            want = _attention_with_grads(ring.dense_reference_attention, q, k, v, up)
            text = _check_attention(f"the ring at world 1, n = {n}", _attention_with_grads(
                lambda a, b, c: ring.ring_self_attention(a, b, c, group), q, k, v, up), want)
            log(f"[ring-tp] ring_self_attention over the one-rank group at (n, h, d) = "
                f"({n}, {h}, {d}) against dense attention (TF32 off): {text}")
            if n == RING_NS[-1]:
                text = _check_attention(f"the block merge over {RING_BLOCKS} blocks",
                                        _attention_with_grads(
                                            lambda a, b, c: ring.blockwise_self_attention(
                                                a, b, c, RING_BLOCKS), q, k, v, up), want)
                log(f"[ring-tp] the block merge over {RING_BLOCKS} blocks of {n // RING_BLOCKS}"
                    f" rows in one process (the ring's schedule, rotated by indexing): {text}")
        del want
    torch.cuda.empty_cache()

    def flash_pair(a, b, c):
        return flash_attention(a.transpose(0, 1)[None], b.transpose(0, 1)[None],
                               c.transpose(0, 1)[None], d**-0.5)[0].transpose(0, 1)

    pairs = {"ring": lambda a, b, c: ring.ring_self_attention(a, b, c, group),
             f"merge over {RING_BLOCKS}": lambda a, b, c: ring.blockwise_self_attention(
                 a, b, c, RING_BLOCKS),
             "dense": ring.dense_reference_attention, "flash pair": flash_pair}
    ms, peaks = {}, {}
    for name, fn in pairs.items():
        torch.cuda.reset_peak_memory_stats()
        ms[name] = _pair_ms(fn, q, k, v, up)
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[ring-tp] forward + backward at (n, h, d) = ({RING_NS[-1]}, {h}, {d}), fp32, events "
        f"(TF32 {torch.backends.cuda.matmul.allow_tf32}): "
        + ", ".join(f"{k} {v:.3f} ms (peak {peaks[k]:.2f} GiB)" for k, v in ms.items())
        + f" on {card_line()}")
    del q, k, v, up
    torch.cuda.empty_cache()

    # (c) the two flagship steps beside [train-dp]'s
    rcfg = fcfg.replace(model=dataclasses.replace(m, attn_backend="ring"))
    seq_mesh = make_mesh((1, 1), ("data", "seq"), device="cuda")
    model_mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    batch, draws = _step_batch(fcfg, sections)
    n = fcfg.train.batch_size
    shard = batch_shard(seq_mesh, n)
    dp_state = create_train_state(m, fcfg.train, "cuda")
    ring_state = create_train_state(rcfg.model, rcfg.train, "cuda")
    tp_state = tp.shard_train_state(create_train_state(m, fcfg.train, "cuda"), model_mesh)
    rules = tp.tp_param_placements(tp_state.model)
    n_rules = sum(type(p).__name__ == "Shard" for p in rules.values())
    if any(isinstance(p, DTensor) for p in tp_state.model.parameters()):
        raise AssertionError("shard_params placed DTensors on a 'model' axis of 1")

    # one step's spot-tower gradients, ring against xla, same weights and batch
    xla_model = MclSTExp(dataclasses.replace(m, attn_backend="xla"), device="cuda")
    xla_model.load_state_dict(ring_state.model.state_dict())
    with torch.no_grad():
        img_emb = ring_state.model.eval().encode_image(
            augment.train_augment_inline(batch["image_u8"], draws))
    with _no_tf32():
        with active_mesh(seq_mesh):
            got = _spot_grads(ring_state.model, img_emb, batch)
        want_grads = _spot_grads(xla_model, img_emb, batch)
        grad_text = _check_spot_grads(got, want_grads, xla_model, img_emb, batch)
    ring_state.model.zero_grad(set_to_none=True)
    del xla_model, img_emb, got, want_grads

    runs = {}
    for name, state, mesh in (("dp", dp_state, seq_mesh), ("ring", ring_state, seq_mesh),
                              ("tp", tp_state, model_mesh)):
        runs[name] = _mesh_steps(fcfg, state, batch, draws, shard, mesh)
    want = m.head_layers * 2
    if runs["ring"][1:3] != ((0, 0, 0), _shear_launches(2)) or \
            runs["tp"][1:3] != ((want, want, want), _shear_launches(2)):
        raise AssertionError(f"[ring-tp] launches: ring {runs['ring'][1:3]}, tp "
                             f"{runs['tp'][1:3]}")
    if runs["tp"][0][0] != runs["dp"][0][0]:
        raise AssertionError(f"[ring-tp] the step at model 1 against [train-dp]'s: first loss "
                             f"{runs['tp'][0][0]} against {runs['dp'][0][0]}")
    log(f"[ring-tp] 2 steps each from the same weights, batch and draws (B={n}): losses "
        + "; ".join(f"{k} {v[0]}" for k, v in runs.items())
        + f"; launches forward/dK-dV/dQ ring {runs['ring'][1]}, tp {runs['tp'][1]}; row_shift "
        f"ring {runs['ring'][2]}, tp {runs['tp'][2]}; peak memory "
        + ", ".join(f"{k} {v[3]:.2f} GiB" for k, v in runs.items())
        + f"; spot-tower gradients (TF32 off): {grad_text}; at model 1 shard_params "
        f"replicates every parameter, as "
        f"JAX's does ({n_rules} would shard on a longer 'model' axis): tensor parallelism "
        f"across cards is not measured on one card")
    times = {"dp": [], "ring": [], "tp": []}
    for name in ("dp", "ring", "tp", "tp", "ring", "dp"):
        state = {"dp": dp_state, "ring": ring_state, "tp": tp_state}[name]
        times[name].append(_mesh_step_ms(rcfg if name == "ring" else fcfg, state, batch, draws,
                                         shard, model_mesh if name == "tp" else seq_mesh))
    log(f"[ring-tp] ms/step at B={n} (dp, ring, tp, tp, ring, dp; 3 steps each): [train-dp]'s "
        f"step {times['dp']}, ('data', 'seq') with 'ring' {times['ring']}, ('data', 'model') "
        f"with 'flash' {times['tp']} on {card_line()}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del dp_state, ring_state, tp_state
    torch.cuda.empty_cache()
    return {"ring": runs["ring"][2], "tp": (runs["tp"][1], runs["tp"][2])}


_STREAM_CHILD = """import dataclasses, json, os, sys
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cudnn.benchmark = False
from mclstexp_tpu_torch.config import her2st_config
from mclstexp_tpu_torch.data import pipeline, synthetic
from mclstexp_tpu_torch.ops.row_shift import row_shift
from mclstexp_tpu_torch.train import loop
from mclstexp_tpu_torch.utils.logging import MetricLogger
out_dir = sys.argv[1]
cfg = her2st_config(out_dir)
m = cfg.model
sections = synthetic.make_dataset(num_sections=3, num_spots=225, num_genes=m.spot_dim,
                                  patch_size=cfg.data.patch_size, seed=0)
streamed = []
prefetch = loop.prefetch_to_device
def counting(*args, **kw):
    streamed.append(1)
    return prefetch(*args, **kw)
loop.prefetch_to_device = counting
result = {}
for name, budget in (("resident", cfg.train.device_data_budget_bytes), ("streamed", 0)):
    run = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=2,
                                                device_data_budget_bytes=budget))
    row_shift.kernel_launches = dict.fromkeys(row_shift.kernel_launches, 0)
    logger = MetricLogger(echo=False)
    state = loop.train_fold(run, sections, 0, logger, device="cuda")
    torch.cuda.synchronize()
    steps = [r for r in logger.records if "loss" in r]
    stamps = [r["time"] for r in steps]
    result[name] = dict(losses=[r["loss"] for r in steps],
                        ms=[(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])],
                        launches=dict(row_shift.kernel_launches), streams=len(streamed),
                        raw_bytes=pipeline.raw_bytes(pipeline.ConcatSections.from_sections(
                            sections[1:])))
    torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
               os.path.join(out_dir, name + ".pt"))
    del state
print(json.dumps(result), flush=True)
"""


def phase_stream() -> dict:
    """[stream] [train]'s fold (her2st widths, "xla") past the device budget
    (``device_data_budget_bytes=0``): every batch streamed through
    ``prefetch_to_device`` (a thread pins each host batch and copies it on
    a side stream ahead of the step) against the resident fold, in a
    process of its own with deterministic algorithms
    (``torch.use_deterministic_algorithms``, ``CUBLAS_WORKSPACE_CONFIG``)
    so that two folds can be bit-equal at all; two epochs: the same losses
    and parameters bit for bit, row_shift's shears launched alike, ms per
    step of each (the steps' log stamps; every step syncs to log its loss).
    Returns the streamed fold's row_shift launches."""
    import subprocess

    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(repo, "build", "chip_smoke", "stream")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()
    env = dict(_child_env(repo), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _STREAM_CHILD, out_dir], capture_output=True,
                          text=True, env=env, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[stream] child exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    resident, streamed = result["resident"], result["streamed"]
    want = torch.load(os.path.join(out_dir, "resident.pt"), weights_only=True)
    got = torch.load(os.path.join(out_dir, "streamed.pt"), weights_only=True)
    equal = sorted(got) == sorted(want) and all(torch.equal(got[k], w) for k, w in want.items())
    if resident["streams"] != 0 or streamed["streams"] != 2 or \
            streamed["losses"] != resident["losses"] or not equal or \
            streamed["launches"] != resident["launches"]:
        raise AssertionError(f"[stream] streamed fold {streamed} against resident {resident}; "
                             f"parameters bit-equal: {equal}")
    log(f"[stream] train_fold past the device budget ({resident['raw_bytes']} raw bytes, "
        f"budget 0), 2 epochs: {len(streamed['losses'])} steps streamed through "
        f"prefetch_to_device, bit-equal to the resident fold (losses {streamed['losses']}, "
        f"every parameter and running statistic), row_shift {streamed['launches']} in both; "
        f"ms of the second epoch's full batches (steps 6, 7; deterministic algorithms): "
        f"resident {resident['ms'][4:6]}, streamed {streamed['ms'][4:6]} (every step: "
        f"{resident['ms']} / {streamed['ms']}); the process {seconds:.1f} s on {card_line()}")
    return streamed["launches"]


def phase_cli_dp(sections, ref_scores: dict) -> int:
    """[cli-dp] ``torchrun --nproc-per-node=1`` running the port's command
    line on [cli]'s tree, each command a process group of one rank over
    NCCL: ``train --fold 0 --max_epochs 1`` (the data-parallel fold) and
    ``baseline --baseline histogene --patch-size 112 --max_epochs 1 --dp``
    (slide-DP, one slide a step padded to the training set's largest
    bucket), each with a fresh patch cache, so each child's cooperative
    pre-cut launches extract_patches once per section. ``train``'s
    checkpoint against [cli]'s (every parameter within 2 lr a step, the
    running statistics within ``DP_STAT_RTOL_LONG``, the epoch loss within
    rtol ``DP_LOSS_RTOL_LONG``: 14 steps on each side); ``baseline --dp``'s
    scores against ``ref_scores``, [cli-baseline]'s HisToGene (finite; MSE
    and MAE within rtol 1e-2, the PCCs within 2e-2: slide-DP pads every
    slide to the largest bucket, so each slide's dropout mask is drawn at
    another shape and the run is another trajectory from the same initial
    weights). Then BLEEP's fold with a mesh in this process at world 1
    (resnet50, [train]'s sections, one epoch: finite losses), and its
    step's loss and gradients against the step without a mesh from the
    same weights, batch and dropout draws (TF32 off, ``DP_GRAD_RTOL``).
    Returns the extract_patches launches of the two children."""
    import subprocess

    import numpy as np
    import torch

    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.core.layers import seed_dropout
    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData
    from mclstexp_tpu_torch.data.st_dataset import her2st_section_names
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.parallel.mesh import make_mesh
    from mclstexp_tpu_torch.train import checkpoint
    from mclstexp_tpu_torch.train.step import Shard
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke", "cli")
    child = os.path.join(work, "cli_child.py")
    with open(child, "w") as f:
        f.write(_CLI_CHILD)
    root = os.path.join(work, "her2st")
    flags = ["--dataset", "her2st", "--data-root", root, "--gene-panel",
             os.path.join(work, "panel", "her2st_hvg_panel.npy"),
             "--checkpoint-dir", "model_result_dp", "--patch-cache", "patch_cache_dp"]
    names = sorted(os.listdir(os.path.join(root, "ST-cnts")))
    torch.cuda.empty_cache()
    seconds, launches, outs = {}, {}, {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for name, argv in (("train", ["train", "--fold", "0", "--max_epochs", "1"]),
                           ("baseline --dp", ["baseline", "--baseline", "histogene",
                                              "--patch-size", "112", "--max_epochs", "1",
                                              "--dp"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node=1", child] + argv + flags,
                capture_output=True, text=True, env=_child_env(repo), timeout=600)
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"torchrun {name} exited {proc.returncode}: "
                                     f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
            out, _, last = proc.stdout.rstrip("\n").rpartition("\n")
            launches[name], outs[name] = json.loads(last), out
        rel = os.path.join("her2st", her2st_section_names(root)[0], "best_0")
        got = checkpoint.restore_checkpoint(os.path.join("model_result_dp", rel))
        want = checkpoint.restore_checkpoint(os.path.join("model_result", rel))
        log_dp = [json.loads(line) for line in open(os.path.join("model_result_dp",
                                                                 "train_log.jsonl"))]
        log_ref = [json.loads(line) for line in open(os.path.join("model_result",
                                                                  "train_log.jsonl"))]
        scores = _printed_json(outs["baseline --dp"])
    finally:
        os.chdir(cwd)
    steps = want["step"]
    diff = _state_diff(got["model"], want["model"])
    loss_dp = [r["epoch_loss"] for r in log_dp if "epoch_loss" in r]
    loss_ref = [r["epoch_loss"] for r in log_ref if "epoch_loss" in r]
    lr = 1e-4  # the CLI's default
    _check_state_diff("[cli-dp] torchrun train's checkpoint", diff, lr, steps,
                      DP_STAT_RTOL_LONG)
    if got["step"] != steps or len(loss_dp) != 1 or \
            not math.isclose(loss_dp[0], loss_ref[0], rel_tol=DP_LOSS_RTOL_LONG):
        raise AssertionError(f"torchrun train: step {got['step']} of {steps}, epoch loss "
                             f"{loss_dp} against {loss_ref}")
    if not all(math.isfinite(scores[k]) for k in ("hvg_pcc", "heg_pcc", "mse", "mae")):
        raise AssertionError(f"baseline --dp scores {scores} ([cli-baseline]: {ref_scores})")
    for k in ("mse", "mae"):
        if not math.isclose(scores[k], ref_scores[k], rel_tol=1e-2):
            raise AssertionError(f"baseline --dp {k} {scores[k]} against {ref_scores[k]}")
    for k in ("hvg_pcc", "heg_pcc"):
        if not abs(scores[k] - ref_scores[k]) <= 2e-2:
            raise AssertionError(f"baseline --dp {k} {scores[k]} against {ref_scores[k]}")
    per_child = {k: v["extract_patches"] for k, v in launches.items()}
    if any(v != len(names) for v in per_child.values()) or \
            any(launches["train"]["row_shift"][k] != v
                for k, v in _shear_launches(steps).items()):
        raise AssertionError(f"torchrun children's launches {launches}; each pre-cut cuts "
                             f"the {len(names)} sections once")
    log(f"[cli-dp] torchrun --nproc-per-node=1 (one rank, NCCL): seconds per command, start to "
        f"exit: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) +
        f"; extract_patches {per_child} (each child's pre-cut of {len(names)} sections on a "
        f"fresh cache), row_shift {launches['train']['row_shift']} in train")
    log(f"[cli-dp] train: {steps} data-parallel steps, epoch loss {loss_dp[0]:.6f} against "
        f"[cli]'s {loss_ref[0]:.6f} (both in TF32: rtol {DP_LOSS_RTOL_LONG}); checkpoint "
        f"{_diff_text(diff, lr, steps, DP_STAT_RTOL_LONG)}")
    log(f"[cli-dp] baseline --dp (slide-DP) HisToGene {scores} against [cli-baseline]'s "
        f"{ {k: ref_scores[k] for k in ('hvg_pcc', 'heg_pcc', 'mse', 'mae')} } (MSE, MAE rtol "
        f"1e-2; PCCs within 2e-2)")

    cfg = _bleep_cfg(max_epochs=1)
    logger = MetricLogger(echo=False)
    mesh = make_mesh(device="cuda")
    try:
        t0 = time.perf_counter()
        state = trainer.train_bleep_fold(cfg, sections, 0, logger=logger, device="cuda",
                                         mesh=mesh)
        torch.cuda.synchronize()
        seconds["bleep"] = time.perf_counter() - t0
        losses = [r["loss"] for r in logger.records]
        if state.step != 4 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"BLEEP with a mesh: {state.step} steps, losses {losses}")
        data = DeviceResidentData(ConcatSections.from_sections(sections[1:]), "cuda")
        batch = data.take(np.arange(cfg.batch_size))
        n = cfg.batch_size
        shard = Shard(torch.distributed.group.WORLD, slice(0, n), n, replicated=False)
        step = trainer.make_bleep_step(cfg)

        def dropout():
            return augment.reseed(torch.Generator(device="cuda"), 0, 0)

        with _no_tf32():
            runs = [_one_step_grads(trainer.init_baseline(cfg, "cuda"),
                                    lambda st, sh=sh: step(st, batch, dropout(), sh))
                    for sh in (None, shard)]

        def exact():
            images = augment.to_float(batch["image_u8"]).double()

            def forward(m):
                seed_dropout(m, dropout())
                image, spot = m({"image": images, "expression": batch["expression"].double()})
                t = cfg.temperature
                targets = torch.softmax((image @ image.T + spot @ spot.T) / 2.0 / t, dim=-1)
                return _xent64(spot @ image.T / t, targets)

            return _fp64_grads(trainer.init_baseline(cfg, "cuda").model, forward)

        with _no_tf32():
            text = _check_grads("[cli-dp] BLEEP's step over the mesh", runs[1], runs[0], exact)
    finally:
        distributed.shutdown()
    log(f"[cli-dp] train_bleep_fold with a one-rank NCCL mesh (resnet50, batch 128, one "
        f"epoch, {state.step} steps) in {seconds['bleep']:.1f} s, epoch loss {losses}; its "
        f"{text}")
    del state, runs, data
    torch.cuda.empty_cache()
    return sum(per_child.values())


def main() -> int:
    import torch

    from mclstexp_tpu_torch.parallel import distributed

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
    linear_entries = phase_linear()
    patch_entry = phase_patches()
    cfg, state, sections, launches = phase_train()
    for entry in entries:
        entry["launches"] = launches[entry["kernel"]]
    phase_reference(cfg, state, sections)
    phase_step_time(cfg, state, sections)
    fcfg, steps, counts = phase_train_flash(cfg, sections, state)
    phase_resume(fcfg, sections, steps)
    dp_counts, dp_shifts = phase_train_dp(fcfg, sections, steps)
    try:
        ring_tp = phase_ring_tp(fcfg, sections)
    finally:
        distributed.shutdown()
    stream_shifts = phase_stream()
    phase_tenx(cfg, sections, state)
    eval_model, eval_launches = phase_eval(cfg, sections)
    serve_launches = phase_serve(cfg, eval_model)
    patch_entry["launches"] = phase_data()
    cli_launches = phase_cli()
    baseline_launches, histogene_scores = phase_cli_baseline()
    cli_dp_launches = phase_cli_dp(sections, histogene_scores)
    seg_entries = phase_segment_kernels()
    seg_counts, thitogene_counts, linear_step = phase_baselines()
    hist2st_counts = phase_hist2st()
    phase_bleep(sections)
    bf16_entries = phase_bf16_kernels()
    bf16_counts = phase_bf16_train(cfg, sections)
    phase_bf16_cli()
    bf16_seg, bf16_tseg, bf16_hseg = phase_bf16_baselines()
    phase_bf16_bleep(sections)
    tutorial_launches = phase_analysis()
    shard_eval_launches = phase_shard_eval()
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
    # Launches on this slice's main path, the tensor-parallel flash step
    # ([ring-tp]); the data-parallel and one-process folds' and the
    # forward's eval and serving counts beside them.
    tp_counts, tp_shifts = ring_tp["tp"]
    flash_entry["launches"] = tp_counts[0]
    flash_entry["launches_by_path"] = {"tp_step": tp_counts[0], "train_dp": dp_counts[0],
                                       "train_flash": counts[0], "eval": eval_launches,
                                       "serve": serve_launches}
    for entry, count, dp_count, tp_count in zip(bwd_entries, counts[1:], dp_counts[1:],
                                                tp_counts[1:]):
        entry["launches"] = tp_count
        entry["launches_by_path"] = {"tp_step": tp_count, "train_dp": dp_count,
                                     "train_flash": count}
    # row_shift on this slice's main path, the sequence- and tensor-parallel
    # steps, beside the data-parallel fold, [train], the streamed fold,
    # [cli] and the tutorial
    for entry in entries:
        kernel = entry["kernel"]
        entry["launches_by_path"] = {"ring_step": ring_tp["ring"][kernel],
                                     "tp_step": tp_shifts[kernel],
                                     "train_dp": dp_shifts[kernel],
                                     "train": entry["launches"],
                                     "stream": stream_shifts[kernel],
                                     "cli": cli_launches["row_shift"][kernel],
                                     "tutorial": tutorial_launches[kernel]}
        entry["launches"] = ring_tp["ring"][kernel] + tp_shifts[kernel]
    # extract_patches on this slice's main path, the torchrun train and
    # baseline --dp children's pre-cuts
    patch_entry["launches_by_path"] = {"cli_dp": cli_dp_launches,
                                       "data": patch_entry["launches"],
                                       "cli": cli_launches["extract_patches"],
                                       "cli_baseline": baseline_launches,
                                       "shard_eval": shard_eval_launches}
    patch_entry["launches"] = cli_dp_launches
    # the linear kernel's products on this slice's main path, a whole-slide
    # HisToGene step (forward, then dX and dW for each product of the backward)
    fwd, bwd = linear_step  # dW for every product, dX for all but the patch embedding's
    for entry, count in zip(linear_entries, (fwd, bwd - fwd, fwd)):
        entry["launches"] = count
        entry["launches_by_path"] = {"histogene_whole_slide": count}
    entries += [flash_entry, *bwd_entries, *linear_entries, patch_entry, *seg_entries,
                *bf16_entries]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
