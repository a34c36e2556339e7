"""Command-line interface of the port: hvg / train / eval / predict / serve /
baseline / export-torch / fetch.

Port of ``mclstexp_tpu/cli/main.py``, with the same subcommands, flags and
defaults over the port's library:

  python -m mclstexp_tpu_torch.cli hvg      --dataset her2st --data-root ... --out ...
  python -m mclstexp_tpu_torch.cli train    --dataset her2st --data-root ... [--fold N]
  python -m mclstexp_tpu_torch.cli eval     --dataset her2st --data-root ...
  python -m mclstexp_tpu_torch.cli predict  --dataset her2st --checkpoint ... --fold N
  python -m mclstexp_tpu_torch.cli serve    --dataset her2st --checkpoint ...
  python -m mclstexp_tpu_torch.cli baseline --baseline hist2st --dataset her2st ... [--fold N]

One flag is the port's own: ``--device`` (default ``cuda``), where the
model, the patch cut and the retrieval run. Without a card the commands that
reach it fail with torch's CUDA error; pass ``--device cpu`` to run on the
CPU. Checkpoints are the port's ``state.pt`` fold directories
(``train/checkpoint.py``); ``export-torch`` and ``eval --torch-checkpoint``
convert to and from the reference's ``.pt`` layout. ``--debug-nans`` is
accepted and ignored (a JAX sanitizer). ``--dtype`` (default ``float32``)
is the compute dtype of every subcommand's model, as in the JAX CLI:
``bfloat16`` trains, evaluates, predicts and serves in bf16 (fp32
parameters, bf16 compute, the JAX rule). A checkpoint keeps no dtype, as
JAX's keep none: ``eval`` of a bf16-trained fold without ``--dtype`` scores
in fp32, as JAX's does.

Several processes, one per card: under ``torchrun --nproc-per-node N``
(or with ``--coordinator``, ``--num-processes`` and ``--process-id``) each
command joins a process group at entry (``parallel/distributed.py``) and
runs on ``cuda:{LOCAL_RANK}``. The ranks then cut the patch cache together,
each its share of the sections, before any reads it; ``train`` trains
data-parallel over every rank (each step one process's step on the global
batch, ``train/loop.py``); ``baseline --dp`` trains data-parallel over
every rank (BLEEP's global batch, the slide families' slide-DP mode;
without ``torchrun``, over a one-rank group); ``eval --shard-eval`` splits
the embedding sweep over the ranks (without ``torchrun``, over a one-rank
group); and only rank 0 writes files and prints the result. The JAX CLI's
``bench`` is not part of the port's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _add_model_flags(p: argparse.ArgumentParser):
    # The reference's train.py flags, same names. Flags whose value the
    # dataset preset may override (notably synthetic's tiny_cnn/32-dim model)
    # default to None, "the preset's value"; the real datasets' presets hold
    # the reference's defaults.
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: preset (reference 128)")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="default: preset (reference 90)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--dim", type=int, default=None, help="spot dim (# HVGs); preset default")
    p.add_argument("--image_embedding_dim", type=int, default=None)
    p.add_argument("--projection_dim", type=int, default=None,
                   help="default: preset (reference 256)")
    p.add_argument("--heads_num", type=int, default=8)
    p.add_argument("--heads_dim", type=int, default=64)
    p.add_argument("--heads_layers", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--encoder_name", type=str, default=None,
                   help="default: preset (reference densenet121)")
    p.add_argument("--pretrained", type=str, default="",
                   help="torch .pt with ImageNet-pretrained tower weights "
                        "(torchvision/timm state_dict); training starts from them")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of the towers (parameters stay float32); a "
                        "checkpoint read by eval/predict/serve keeps its own")
    p.add_argument("--debug-nans", action="store_true",
                   help="accepted for the JAX CLI's sake and ignored")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)


def _add_dist_flags(p: argparse.ArgumentParser):
    # Several processes, one per card. torchrun's environment needs none of
    # these; they spell the rendezvous out where no launcher sets it.
    p.add_argument("--coordinator", type=str, default="",
                   help="rendezvous address host:port of rank 0 (tcp://); omit under "
                        "torchrun")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _add_data_flags(p: argparse.ArgumentParser):
    p.add_argument("--dataset", type=str, default="her2st",
                   choices=["her2st", "cscc", "visium", "synthetic"])
    p.add_argument("--data-root", type=str, default="",
                   help="root of the raw dataset files")
    p.add_argument("--gene-panel", type=str, default="",
                   help="path to HVG panel (.npy/.pkl); defaults to the shipped panel")
    p.add_argument("--preprocessed-root", type=str,
                   default="data/preprocessed_expression_matrices")
    p.add_argument("--patch-cache", type=str, default="patch_cache")
    p.add_argument("--patch-size", type=int, default=None,
                   help="default: preset (224 for the contrastive model)")
    p.add_argument("--no-pos-remap", action="store_true",
                   help="disable the dense coordinate remap even where the "
                        "preset enables it (visium), to load checkpoints "
                        "trained with the reference's full 65536-row tables")
    p.add_argument("--checkpoint-dir", type=str, default="model_result")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model, the patch cut and the retrieval run "
                        "(default: the card; cpu to run without one)")


def _build_config(args):
    from mclstexp_tpu_torch.config import ENCODER_DIMS, get_config

    cfg = get_config(args.dataset)
    encoder = args.encoder_name or cfg.model.encoder_name
    model = dataclasses.replace(
        cfg.model,
        encoder_name=encoder,
        image_dim=args.image_embedding_dim
        or (ENCODER_DIMS[encoder] if args.encoder_name else cfg.model.image_dim),
        spot_dim=args.dim or cfg.model.spot_dim,
        projection_dim=args.projection_dim or cfg.model.projection_dim,
        heads_num=args.heads_num,
        heads_dim=args.heads_dim,
        head_layers=args.heads_layers,
        dropout=args.dropout,
        temperature=args.temperature,
        dtype=args.dtype,
        pretrained_path=args.pretrained or None,
    )
    train = dataclasses.replace(
        cfg.train,
        batch_size=args.batch_size or cfg.train.batch_size,
        max_epochs=(args.max_epochs
                    if args.max_epochs is not None else cfg.train.max_epochs),
        lr=args.lr if args.lr is not None else cfg.train.lr,
        weight_decay=args.weight_decay,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        debug_nans=getattr(args, "debug_nans", False),
    )
    data = dataclasses.replace(
        cfg.data,
        data_root=args.data_root,
        gene_panel=args.gene_panel,
        preprocessed_root=getattr(args, "preprocessed_root", cfg.data.preprocessed_root),
        patch_cache_dir=args.patch_cache,
        patch_size=getattr(args, "patch_size", None) or cfg.data.patch_size,
        pos_remap=(cfg.data.pos_remap
                   and not getattr(args, "no_pos_remap", False)),
    )
    return dataclasses.replace(cfg, model=model, train=train, data=data)


def _load_sections(cfg, with_patches: bool = True, device="cuda"):
    """The preset's sections; patches are cut on ``device`` (the
    extract_patches kernel on the card) into a cache per dataset and patch
    size. In a process group the ranks first cut the cache together, each
    its ``process_shard`` of the sections, and wait for each other before
    any rank reads it (the cache directory must be shared by all ranks)."""
    from mclstexp_tpu_torch.data import genes, synthetic
    from mclstexp_tpu_torch.data.st_dataset import (
        cscc_section_names, her2st_section_names, load_cscc, load_her2st,
    )
    from mclstexp_tpu_torch.data.visium import VISIUM_SECTIONS, load_visium
    from mclstexp_tpu_torch.parallel import distributed

    ds = cfg.data.dataset
    if ds == "synthetic":
        return synthetic.make_dataset(patch_size=cfg.data.patch_size)
    ps = cfg.data.patch_size
    # one cache per (dataset, patch size): a wrong-size cache reads as a miss
    cache = os.path.join(cfg.data.patch_cache_dir, f"{ds}_{ps}")

    def load(names=None):
        if ds == "visium":
            kw = {} if names is None else {"names": names}
            return load_visium(cfg.data.data_root, cfg.data.preprocessed_root, patch_size=ps,
                               cache_dir=cache, with_patches=with_patches, device=device,
                               **kw)
        panel = genes.load_panel(ds, cfg.data.gene_panel or None)
        return {"her2st": load_her2st, "cscc": load_cscc}[ds](
            cfg.data.data_root, panel, names=names, patch_size=ps, cache_dir=cache,
            with_patches=with_patches, device=device)

    if with_patches and distributed.is_initialized():
        if ds == "her2st":
            all_names = her2st_section_names(cfg.data.data_root)
        elif ds == "cscc":
            all_names = cscc_section_names()
        else:
            all_names = list(VISIUM_SECTIONS)
        load(names=all_names[distributed.process_shard(len(all_names))])
        distributed.sync_hosts("patch-cache-precut")
    return load()


def _maybe_remap(cfg, sections, prefer_saved: bool = False):
    """Apply the dense coordinate remap when the preset asks for it (visium:
    raw pixel coordinates -> dense rows, ``pos_vocab`` shrunk to match).
    Returns (cfg, sections, remap or None).

    ``prefer_saved``: the commands that read a checkpoint (eval, predict,
    serve, train --resume) load the ``pos_remap.npz`` that train saved: the
    mapping defines the checkpoint's table rows, and one rebuilt from a
    dataset that has since changed would permute them. Fresh training builds
    the mapping over all loaded sections."""
    if not cfg.data.pos_remap:
        return cfg, sections, None
    from mclstexp_tpu_torch.data.posremap import PosRemap

    saved = os.path.join(cfg.train.checkpoint_dir, cfg.data.dataset, "pos_remap.npz")
    if prefer_saved and os.path.exists(saved):
        remap = PosRemap.load(saved)
    else:
        remap = PosRemap.build(sections)
    sections = remap.apply_sections(sections)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, pos_vocab=remap.vocab)
    )
    return cfg, sections, remap


def _visium_matrix_dirs(cfg) -> dict:
    from mclstexp_tpu_torch.data.visium import VISIUM_SECTIONS, VISIUM_SECTIONS_ALEX

    return {
        name: os.path.join(cfg.data.data_root, name,
                           "filtered_count_matrix" if name in VISIUM_SECTIONS_ALEX
                           else "filtered_feature_bc_matrix")
        for name in VISIUM_SECTIONS
    }


def cmd_hvg(args) -> int:
    """Per-section preprocessed expression matrices, or with
    ``--select-panel`` a fresh HVG panel (the reference's hvg scripts)."""
    cfg = _build_config(args)
    if args.select_panel:
        from mclstexp_tpu_torch.data import panel as panel_mod

        if cfg.data.dataset == "visium":
            frames = panel_mod.visium_count_frames(_visium_matrix_dirs(cfg))
        else:
            frames = panel_mod.count_frames_for_dataset(cfg.data.dataset, cfg.data.data_root)
        sel = panel_mod.select_panel(
            frames,
            n_top_genes=args.n_top_genes,
            min_sections=args.panel_min_sections,
            panel_size=args.panel_size,
        )
        out_dir = args.out or os.path.join(
            cfg.data.preprocessed_root, f"{cfg.data.dataset}_panel"
        )
        path = panel_mod.save_panel_artifacts(sel, out_dir, cfg.data.dataset)
        print(
            f"panel: {len(sel.panel)} genes -> {path} "
            f"(union {int(sel.union.sum())}, "
            f"intersection {int(sel.intersection.sum())}, "
            f"{len(sel.shared_genes)} shared genes, "
            f"{len(sel.section_names)} sections)"
        )
        return 0
    if cfg.data.dataset == "visium":
        # raw 10x counts -> gene x spot matrices; the sections need them first
        from mclstexp_tpu_torch.data import genes
        from mclstexp_tpu_torch.data.visium import build_visium_preprocessed

        panel = genes.load_panel("visium", cfg.data.gene_panel or None)
        matrix_dirs = _visium_matrix_dirs(cfg)
        out_root = args.out or cfg.data.preprocessed_root
        build_visium_preprocessed(matrix_dirs, out_root, panel)
        print(f"wrote {len(matrix_dirs)} matrices under {out_root}")
        return 0
    sections = _load_sections(cfg, with_patches=False, device=args.device)
    out_root = os.path.join(args.out or cfg.data.preprocessed_root, cfg.data.dataset)
    for s in sections:
        d = os.path.join(out_root, s.name)
        os.makedirs(d, exist_ok=True)
        # the reference's layout and normalization: genes x spots, per-gene
        # library-size normalized, over the spots the spot file joins
        np.save(os.path.join(d, "preprocessed_matrix.npy"), s.eval_expression.T)
        print(f"{s.name}: {s.eval_expression.T.shape} -> {d}/preprocessed_matrix.npy")
    return 0


def cmd_train(args) -> int:
    """Train one fold or all of them; in a process group, data-parallel
    over every rank (``train_fold``'s mesh), rank 0 writing the files."""
    cfg = _build_config(args)
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.train.loop import train_all_folds, train_fold
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    sections = _load_sections(cfg, device=args.device)
    cfg, sections, remap = _maybe_remap(cfg, sections, prefer_saved=args.resume)
    if remap is not None and distributed.rank() == 0:
        # the row assignment the checkpoints are trained under (_maybe_remap)
        d = os.path.join(cfg.train.checkpoint_dir, cfg.data.dataset)
        os.makedirs(d, exist_ok=True)
        remap.save(os.path.join(d, "pos_remap.npz"))
    distributed.sync_hosts("pos-remap")
    logger = MetricLogger(path=os.path.join(cfg.train.checkpoint_dir, "train_log.jsonl"))
    try:
        if args.fold is not None:
            train_fold(cfg, sections, args.fold, logger=logger, device=args.device,
                       resume=args.resume)
        else:
            train_all_folds(cfg, sections, logger=logger, device=args.device)
    finally:
        logger.close()
    return 0


def _print_averages(avg) -> None:
    # the reference's four printed averages
    print(f"avg heg pcc: {avg['heg_pcc']:.4f}")
    print(f"avg hvg pcc: {avg['hvg_pcc']:.4f}")
    print(f"Mean Squared Error (MSE): {avg['mse']:.4f}")
    print(f"Mean Absolute Error (MAE): {avg['mae']:.4f}")


def _preprocessed_section_names(cfg, root: str) -> List[str]:
    """Section order for --from-embeddings ground truth: the dataset's own
    order where it defines one (cscc's patient x replicate grid, visium's
    section tuple, her2st's ST-cnts listing), else the sorted listing, so a
    stray directory cannot shift the fold indices."""
    listing = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    ds = cfg.data.dataset
    if ds == "cscc":
        from mclstexp_tpu_torch.data.st_dataset import cscc_section_names

        names = cscc_section_names()
    elif ds == "visium":
        from mclstexp_tpu_torch.data.visium import VISIUM_SECTIONS

        names = list(VISIUM_SECTIONS)
    elif ds == "her2st" and cfg.data.data_root:
        from mclstexp_tpu_torch.data.st_dataset import her2st_section_names

        names = her2st_section_names(cfg.data.data_root)
    else:
        return listing
    missing = [n for n in names if n not in listing]
    if missing:
        raise FileNotFoundError(
            f"preprocessed matrices missing for sections {missing} under {root}"
        )
    return names


def _write_json(path: str, results) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=2)


def cmd_eval(args) -> int:
    """The LOO protocol: per fold, the embedding sweep under the fold's
    checkpoint and the retrieval metrics; prints the four averages.
    ``--shard-eval`` splits the sweep over the process group's ranks
    (``compute_embeddings_sharded``; ignored under the Visium eval-time
    augmentation, as in JAX); every rank then scores every fold, and rank 0
    alone writes the prediction, embedding and JSON files and prints."""
    cfg = _build_config(args)
    from mclstexp_tpu_torch.infer import embed, evaluate
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.train import checkpoint as ckpt
    from mclstexp_tpu_torch.train.loop import check_positions_in_vocab
    from mclstexp_tpu_torch.train.state import create_train_state

    if args.from_embeddings:
        if args.device_metrics:
            print("--device-metrics applies to the checkpoint eval path; "
                  "--from-embeddings scores host dumps with the fp64 "
                  "bundle (flag ignored)", file=sys.stderr)
        # score embedding dumps (the reference's phase B) against the
        # preprocessed gene x spot matrices; no model or checkpoint
        root = os.path.join(cfg.data.preprocessed_root, cfg.data.dataset)
        names = _preprocessed_section_names(cfg, root)
        expressions = [
            np.load(os.path.join(root, nm, "preprocessed_matrix.npy")).T.astype(np.float32)
            for nm in names
        ]
        results = evaluate.evaluate_from_embedding_dumps(
            args.from_embeddings,
            expressions,
            top_k=cfg.eval.top_k,
            weight_ord=cfg.eval.weight_ord,
            folds=[args.fold] if args.fold is not None else None,
            prediction_dir=cfg.eval.prediction_dir,
            section_names=names,
            device=args.device,
        )
        _print_averages(results["avg"])
        if args.json:
            _write_json(args.json, results)
        return 0

    sections = _load_sections(cfg, device=args.device)
    cfg, sections, remap = _maybe_remap(cfg, sections, prefer_saved=True)
    check_positions_in_vocab(sections, cfg.model.pos_vocab)
    sizes = [s.num_spots for s in sections]
    # keys and ground truth in the eval normalization (per gene); the model
    # embeds the train-normalized expression
    expressions = [s.eval_expression for s in sections]
    folds = [args.fold] if args.fold is not None else list(range(len(sections)))
    state = create_train_state(cfg.model, cfg.train, args.device)

    prepared = embed.prepare_eval_arrays(sections, device=args.device)  # one upload
    bounds = evaluate.section_bounds(sizes)
    mesh = None
    if args.shard_eval and not cfg.data.eval_time_augment:
        from mclstexp_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=args.device)
        print(f"eval --shard-eval: rank {distributed.rank()} of world size "
              f"{distributed.world_size()} on {args.device}", file=sys.stderr, flush=True)
    lead = distributed.rank() == 0  # the one rank that writes files and prints
    per_fold = []
    for fold in folds:
        if args.torch_checkpoint:
            # a reference-layout .pt (key shims and table slices on import)
            from mclstexp_tpu_torch.models.image.torch_import import load_into_state

            pt = args.torch_checkpoint.format(fold=fold, name=sections[fold].name)
            load_into_state(state, pt, cfg.model, pos_remap=remap)
        else:
            ckpt.load_checkpoint(ckpt.fold_checkpoint_dir(
                cfg.train.checkpoint_dir, cfg.data.dataset, sections[fold].name, fold),
                state.model)
        if mesh is not None:
            img, spot = embed.compute_embeddings_sharded(
                state.model, sections, mesh, cfg.eval.batch_size,
                raw_scale=cfg.data.visium_raw_scale, prepared=prepared, as_device=True,
                device=args.device,
            )
        else:
            img, spot = embed.compute_embeddings(
                state.model, sections, cfg.eval.batch_size,
                eval_augment=cfg.data.eval_time_augment, prepared=prepared,
                raw_scale=cfg.data.visium_raw_scale, as_device=True, device=args.device,
            )
        if args.save_embeddings and lead:
            out_dir = os.path.join(cfg.eval.embedding_dir,
                                   f"{cfg.data.dataset}_result", f"embeddings_{fold}")
            embed.save_embedding_files(img.cpu().numpy(), spot.cpu().numpy(), sizes, out_dir)
        pred_path = None
        # prediction dumps for the full protocol only (one fold: `predict`)
        if cfg.eval.prediction_dir and len(folds) == len(sections) and lead:
            pred_path = os.path.join(cfg.eval.prediction_dir, sections[fold].name,
                                     "matched_spot_expression_pred.npy")
        per_fold.append(evaluate.evaluate_fold_resident(
            fold, img, spot, prepared["eval_expression"], bounds, expressions[fold],
            top_k=cfg.eval.top_k, weight_ord=cfg.eval.weight_ord,
            prediction_path=pred_path, device_metrics=args.device_metrics,
            device=args.device,
        ))

    results = {
        "per_fold": per_fold,
        "folds": folds,
        "avg": {k: float(np.mean([m[k] for m in per_fold])) for k in per_fold[0]},
    }
    if lead:
        _print_averages(results["avg"])
        if args.json:
            _write_json(args.json, results)
    return 0


def _restored_model(cfg, checkpoint: str, device):
    """A model of ``cfg`` (in ``--dtype``'s compute dtype) on ``device``
    holding the weights of the checkpoint directory ``checkpoint``."""
    from mclstexp_tpu_torch.train import checkpoint as ckpt
    from mclstexp_tpu_torch.train.state import create_train_state

    model = create_train_state(cfg.model, cfg.train, device).model
    ckpt.load_checkpoint(checkpoint, model)
    return model


def cmd_predict(args) -> int:
    """Predict expression for one held-out section from a checkpoint."""
    cfg = _build_config(args)
    from mclstexp_tpu_torch.infer import embed, evaluate

    sections = _load_sections(cfg, device=args.device)
    cfg, sections, _ = _maybe_remap(cfg, sections, prefer_saved=True)
    model = _restored_model(cfg, args.checkpoint, args.device)
    img, spot = embed.compute_embeddings(
        model, sections, cfg.eval.batch_size,
        eval_augment=cfg.data.eval_time_augment,
        raw_scale=cfg.data.visium_raw_scale, device=args.device,
    )
    sizes = [s.num_spots for s in sections]
    out = evaluate.evaluate_fold(
        args.fold,
        embed.split_by_section(img, sizes)[args.fold],
        embed.split_by_section(spot, sizes),
        [s.eval_expression for s in sections],
        top_k=cfg.eval.top_k,
        weight_ord=cfg.eval.weight_ord,
        prediction_path=args.out,
        device=args.device,
    )
    print(json.dumps(out, indent=2))
    return 0


def cmd_serve(args) -> int:
    """Serve patch -> predicted expression over HTTP from one checkpoint.

    The spot database (every loaded section's embeddings and expression
    profiles) is built once and stays on the device; each POST /predict
    runs the image tower and the top-K retrieval (``infer/serve.py``).
    ``--exclude-fold`` masks one section out of retrieval after all
    sections are embedded together, as the LOO protocol does. The visium
    preset's eval-time random augmentation is not applied to queries: a
    server answers the same patch with the same prediction."""
    cfg = _build_config(args)
    from mclstexp_tpu_torch.infer.serve import PredictionService, make_server

    # the database is spot-tower only: no patches load
    sections = _load_sections(cfg, with_patches=False, device=args.device)
    cfg, sections, _ = _maybe_remap(cfg, sections, prefer_saved=True)
    model = _restored_model(cfg, args.checkpoint, args.device)
    gene_names = None
    if cfg.data.dataset != "synthetic":
        from mclstexp_tpu_torch.data import genes

        gene_names = genes.load_panel(cfg.data.dataset, cfg.data.gene_panel or None)
    service = PredictionService.from_sections(
        model, sections,
        batch_size=cfg.eval.batch_size, exclude_section=args.exclude_fold,
        top_k=cfg.eval.top_k, weight_ord=cfg.eval.weight_ord,
        raw_scale=cfg.data.visium_raw_scale, max_batch=args.max_batch,
        gene_names=gene_names, patch_size=cfg.data.patch_size, device=args.device,
    )
    try:
        server = make_server(service, host=args.host, port=args.port)
        host, port = server.server_address[:2]
        print(json.dumps({"serving": f"http://{host}:{port}", **service.info()}), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:  # pragma: no cover
            pass
        finally:
            server.server_close()
    finally:
        service.close()
    return 0


def _find_saved_remap(checkpoint_path: str) -> Optional[str]:
    """Walk up from a fold checkpoint dir (…/<dataset>/<section>/best_<fold>)
    to the pos_remap.npz that `train` saved at …/<dataset>/."""
    d = os.path.abspath(checkpoint_path)
    for _ in range(4):
        cand = os.path.join(d, "pos_remap.npz")
        if os.path.exists(cand):
            return cand
        d = os.path.dirname(d)
    return None


def cmd_export_torch(args) -> int:
    """Export a fold checkpoint to the reference's torch .pt layout, which
    the reference's eval scripts load unchanged; the export is imported
    back and compared bit for bit before the file is written."""
    cfg = _build_config(args)
    if args.variant != "attention":
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant=args.variant)
        )
    from mclstexp_tpu_torch.data.posremap import PosRemap
    from mclstexp_tpu_torch.models.image.torch_export import save_reference_checkpoint
    from mclstexp_tpu_torch.train import checkpoint as ckpt

    remap = None
    if args.pos_remap:
        remap = PosRemap.load(args.pos_remap)
    elif cfg.data.pos_remap:
        # a pos_remap checkpoint holds dense-row tables: written without the
        # mapping, its rows would land at raw coordinates 0..vocab-1 and the
        # reference would read zeros for every real coordinate
        cand = _find_saved_remap(args.checkpoint)
        if cand is None:
            raise SystemExit(
                "this preset trains with pos_remap (compact dense-row "
                "positional tables); exporting without the mapping would "
                "write a silently-corrupt reference .pt. Pass --pos-remap "
                "<pos_remap.npz> (written by `train` under "
                "<checkpoint-dir>/<dataset>/), or --no-pos-remap if the "
                "checkpoint was trained with full 65536-row tables."
            )
        remap = PosRemap.load(cand)
        print(f"using coordinate remap: {cand}")
    restored = ckpt.restore_checkpoint(args.checkpoint)
    path = save_reference_checkpoint(args.out, restored["model"], cfg.model,
                                     pos_rows=args.pos_rows, pos_remap=remap)
    print(f"wrote reference-layout state_dict: {path}")
    return 0


def cmd_baseline(args) -> int:
    """Train and score one baseline family on one fold (the comparison the
    reference vendors under ``baselines/``), on ``--device``.

    Training saves the port's ``state.pt`` to ``--checkpoint-dir``'s
    ``baselines/<family>/best_<fold>`` unless ``--no-save``;
    ``--load-checkpoint`` restores such a directory and ``--torch-checkpoint``
    a reference-trained ``.pt`` or Lightning ``.ckpt``
    (``baselines/torch_import.py``), each scored without training. BLEEP is
    scored by retrieval in ``--bleep-retrieval``'s mode, the slide families
    on the held-out slide; ``--super-resolution`` also predicts that slide's
    dense 56-px grid (``baselines/super_resolution.py``) into an ``.npz``.
    Prints the result as JSON. Attention is "xla": the JAX CLI has no
    backend flag for the baselines. ``--dp`` trains data-parallel over a
    mesh of every rank of the process group (a one-rank group without
    ``torchrun``): BLEEP on the global batch, the slide families in the
    slide-DP mode, one slide per rank a step. Rank 0 alone writes the
    checkpoint and prints."""
    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.train import checkpoint as ckpt

    cfg = _build_config(args)
    sections = _load_sections(cfg, device=args.device)
    # THItoGene's reference flow deepens the ViT for cSCC
    # (THItoGene/train.py:19-23: n_layers 4 her2st / 8 skin)
    n_layers = args.n_layers
    if n_layers is None and args.baseline == "thitogene" and cfg.data.dataset == "cscc":
        n_layers = 8
    bcfg = trainer.BaselineConfig(
        model=args.baseline,
        n_genes=sections[0].num_genes,
        patch_size=cfg.data.patch_size,
        max_epochs=args.max_epochs,
        n_layers=n_layers,
        lr=args.lr,
        # the parser's None sentinels: an unset flag falls through to the
        # family's reference default
        weight_decay=args.weight_decay,
        dropout=args.dropout if args.dropout is not None else 0.2,
        temperature=args.temperature if args.temperature is not None else 1.0,
        seed=args.seed,
        zinb_coef=args.zinb,
        bake=args.bake,
        lamb=args.lamb,
        batch_size=args.batch_size or trainer.BaselineConfig.batch_size,
        dtype=args.dtype,
        encoder_name=args.bleep_encoder,
    )

    mesh = None
    if args.dp and not (args.torch_checkpoint or args.load_checkpoint):
        from mclstexp_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=args.device)
    if args.torch_checkpoint or args.load_checkpoint:
        state = trainer.init_baseline(bcfg, args.device)
        if args.torch_checkpoint:
            from mclstexp_tpu_torch.baselines.torch_import import (
                load_baseline_torch_checkpoint,
            )

            load_baseline_torch_checkpoint(args.torch_checkpoint, args.baseline, state.model)
        else:
            ckpt.apply_checkpoint(state, ckpt.restore_checkpoint(args.load_checkpoint))
    elif args.baseline == "bleep":
        state = trainer.train_bleep_fold(bcfg, sections, args.fold, device=args.device,
                                         mesh=mesh)
    else:
        state = trainer.train_baseline_fold(bcfg, sections, args.fold, device=args.device,
                                            mesh=mesh)
    lead = distributed.rank() == 0
    if not args.load_checkpoint and not args.torch_checkpoint and not args.no_save:
        out_dir = os.path.join(cfg.train.checkpoint_dir, "baselines", args.baseline,
                               f"best_{args.fold}")
        ckpt.save_checkpoint_on_lead(out_dir, state)
        if lead:
            print(f"checkpoint: {out_dir}", file=sys.stderr)

    model = state.model
    if args.baseline == "bleep":
        from mclstexp_tpu_torch.infer import embed, evaluate

        img, spot = trainer.bleep_embeddings(model, sections)
        sizes = [s.num_spots for s in sections]
        # the reference notebook's three modes (BLEEP_inference.ipynb cell 5)
        top_k, weight_ord = {
            "simple": (1, 0),  # nearest match only
            "average": (50, 0),  # uniform top-50
            "weighted": (50, -1),  # exp(-(d^2 - d_top^2 + 1)) top-50
        }[args.bleep_retrieval]
        result = evaluate.evaluate_fold(
            args.fold,
            embed.split_by_section(img, sizes)[args.fold],
            embed.split_by_section(spot, sizes),
            [s.eval_expression for s in sections],
            top_k=top_k,
            weight_ord=weight_ord,
            device=args.device,
        )
    else:
        result = trainer.evaluate_baseline_fold(bcfg, sections, args.fold, model)
        if args.super_resolution and lead:
            result["super_resolution"] = _baseline_super_resolution(args, cfg, bcfg, model,
                                                                    sections)
    if lead:
        print(json.dumps(result, indent=2))
    return 0


def _baseline_super_resolution(args, cfg, bcfg, model, sections) -> dict:
    """The held-out section's dense-grid prediction (HisToGene's SR mode,
    reference ``predict.py:46-68``), written as (predictions, centers) to
    the ``--super-resolution`` path."""
    from mclstexp_tpu_torch.baselines.super_resolution import sr_predict
    from mclstexp_tpu_torch.data.io import load_slide
    from mclstexp_tpu_torch.data.st_dataset import her2st_slide_path

    if cfg.data.dataset != "her2st":
        raise SystemExit("--super-resolution needs --dataset her2st "
                         "(the reference SR tutorial's dataset)")
    section = sections[args.fold]
    slide = load_slide(her2st_slide_path(cfg.data.data_root, section.name))
    preds, centers = sr_predict(model, section, slide, bcfg)
    out = args.super_resolution
    np.savez(out, predictions=preds, centers=centers)
    return {"path": out, "grid_spots": int(len(centers))}


def cmd_fetch(args) -> int:
    """Acquire a dataset and print the hvg/train commands to run next."""
    from mclstexp_tpu_torch.data.fetch import fetch

    return fetch(args.dataset, args.dest, dry_run=args.dry_run)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="mclstexp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("hvg", help="build preprocessed expression matrices")
    _add_model_flags(p); _add_data_flags(p); _add_dist_flags(p)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--select-panel", action="store_true",
                   help="emit panel artifacts (per-section HVG masks, "
                        "union/intersection pickles, panel .npy for "
                        "--gene-panel) instead of preprocessed matrices")
    p.add_argument("--n-top-genes", type=int, default=1000,
                   help="HVGs per section (the reference's n_top_genes)")
    p.add_argument("--panel-min-sections", type=int, default=1,
                   help="keep genes selected by >= this many sections (1 == union)")
    p.add_argument("--panel-size", type=int, default=None,
                   help="truncate the panel to this many genes (ranked by "
                        "selection frequency, then mean dispersion)")
    p.set_defaults(fn=cmd_hvg)

    p = sub.add_parser("train", help="train folds (leave-one-section-out)")
    _add_model_flags(p); _add_data_flags(p); _add_dist_flags(p)
    p.add_argument("--fold", type=int, default=None, help="single fold; default all")
    p.add_argument("--resume", action="store_true")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="LOO retrieval evaluation")
    _add_model_flags(p); _add_data_flags(p); _add_dist_flags(p)
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--save-embeddings", action="store_true")
    p.add_argument("--shard-eval", action="store_true",
                   help="split the B=32 embedding sweep over the process group's ranks "
                        "(torchrun; one rank without it); per-batch outputs as on one "
                        "card; ignored when the Visium eval-augment quirk is on")
    p.add_argument("--from-embeddings", type=str, default="",
                   help="score pre-computed embedding dumps under this root "
                        "(per-fold embeddings_<fold>/ dirs in the reference "
                        "layout); no model or checkpoint")
    p.add_argument("--torch-checkpoint", type=str, default="",
                   help="reference .pt template, e.g. "
                        "'model_result/her2st/{name}/best_{fold}.pt'; scores "
                        "reference-layout checkpoints without retraining")
    p.add_argument("--json", type=str, default="", help="write full results JSON")
    p.add_argument("--device-metrics", action="store_true",
                   help="compute the per-fold metric bundle on the device (fp32, "
                        "four scalars read back per fold instead of the full "
                        "prediction matrix)")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("predict", help="predict expression for one section")
    _add_model_flags(p); _add_data_flags(p); _add_dist_flags(p)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--fold", type=int, required=True)
    p.add_argument("--out", type=str, default="")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("baseline", help="train/eval a baseline family")
    _add_model_flags(p); _add_data_flags(p); _add_dist_flags(p)
    # None sentinels: unset flags fall through to each family's reference
    # defaults in BaselineConfig instead of the flagship defaults above
    p.set_defaults(weight_decay=None, dropout=None, temperature=None)
    p.add_argument("--baseline", type=str, required=True,
                   choices=["histogene", "hist2st", "thitogene", "bleep"])
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--zinb", type=float, default=0.25)
    p.add_argument("--bake", type=int, default=None,
                   help="Hist2ST distillation passes; default = reference's 5")
    p.add_argument("--lamb", type=float, default=0.5)
    p.add_argument("--bleep-encoder", type=str, default="resnet50",
                   choices=["resnet50", "res101", "resnet152", "vit", "vit_l",
                            "clip_vit", "tiny_cnn"],
                   help="BLEEP image tower (reference "
                        "baselines/Bleep/modules.py:7-132 menu)")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel training over every rank of the process group "
                        "(torchrun; one rank without it): BLEEP keeps its exact "
                        "global-batch objective; the slide families run slide-per-rank "
                        "with mean gradients (torch-DDP-at-batch-1 semantics - a scaling "
                        "mode, not the sequential parity trajectory)")
    p.add_argument("--bleep-retrieval", type=str, default="average",
                   choices=["simple", "average", "weighted"],
                   help="BLEEP inference mode (BLEEP_inference.ipynb cell 5): "
                        "nearest match / uniform top-50 / exp-weighted top-50")
    p.add_argument("--no-save", action="store_true",
                   help="skip the end-of-training checkpoint")
    p.add_argument("--load-checkpoint", type=str, default="",
                   help="restore this baseline checkpoint instead of training")
    p.add_argument("--torch-checkpoint", type=str, default="",
                   help="score a reference-trained torch/Lightning baseline "
                        "checkpoint (.pt state_dict or Lightning .ckpt) "
                        "without retraining (baselines/torch_import.py)")
    p.add_argument("--super-resolution", type=str, default="",
                   help="also predict the held-out section on the dense 56-px "
                        "grid (HisToGene SR mode) and write (predictions, "
                        "centers) to this .npz")
    p.add_argument("--n-layers", type=int, default=None,
                   help="slide-ViT depth; default = the family's reference "
                        "flow (HisToGene 8, THItoGene 4/8 by dataset)")
    # each family resolves its reference flow's lr and epochs
    # (trainer._FAMILY_LR / _FAMILY_EPOCHS)
    p.set_defaults(fn=cmd_baseline, lr=None, max_epochs=None)

    p = sub.add_parser("serve", help="HTTP prediction service from a checkpoint")
    _add_model_flags(p); _add_data_flags(p); _add_dist_flags(p)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint directory (a fold's best_<k> dir)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8777,
                   help="0 binds an ephemeral port (printed on startup)")
    p.add_argument("--max-batch", type=int, default=256,
                   help="largest patch-count bucket of the image tower; bigger "
                        "requests are chunked")
    p.add_argument("--exclude-fold", type=int, default=None,
                   help="drop this section from the retrieval database "
                        "(LOO-held-out semantics)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export-torch",
                       help="export a checkpoint to a reference torch .pt")
    _add_model_flags(p); _add_data_flags(p); _add_dist_flags(p)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint directory (a fold's best_<k> dir)")
    p.add_argument("--out", type=str, required=True, help="output .pt path")
    p.add_argument("--variant", type=str, default="attention",
                   choices=["attention", "mlp"])
    p.add_argument("--pos-rows", type=int, default=65536,
                   help="pad the positional tables back to this many rows "
                        "(the reference's nn.Embedding(65536) layout; ST "
                        "presets train on a sliced prefix)")
    p.add_argument("--pos-remap", type=str, default="",
                   help="pos_remap.npz written by `train` for a pos_remap "
                        "preset (visium): scatter the compact table rows "
                        "back to their raw-coordinate rows")
    p.set_defaults(fn=cmd_export_torch)

    p = sub.add_parser("fetch", help="download a dataset and print next steps")
    p.add_argument("dataset", choices=["her2st", "cscc", "visium"])
    p.add_argument("--dest", type=str, default="./datasets",
                   help="download root (data-root paths are printed after)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the fetch commands without executing")
    p.set_defaults(fn=cmd_fetch)

    args = parser.parse_args(argv)
    if not hasattr(args, "device"):  # fetch
        return args.fn(args)
    # Several processes (torchrun, or the explicit flags): join the group,
    # each on its own card; a no-op for one process. A group this command
    # made (here or by eval --shard-eval's mesh) ends with it.
    from mclstexp_tpu_torch.parallel import distributed

    had_group = distributed.is_initialized()
    distributed.maybe_initialize_distributed(
        args.coordinator or None, args.num_processes, args.process_id, device=args.device)
    if distributed.is_initialized():
        args.device = distributed.local_device(args.device)
    try:
        return args.fn(args)
    finally:
        if not had_group:
            distributed.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
