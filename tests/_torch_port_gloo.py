"""One rank of the port's multi-process test jobs (gloo, on the CPU).

``tests/test_torch_port_sharded.py`` starts ``world`` processes on
``run``; each joins a gloo group through a ``FileStore`` under ``work``
(no TCP port, so parallel test workers cannot collide), runs the sharded
paths on the inputs the test wrote to ``work/inputs.pt`` and saves what it
got to ``work/result_<world>_<rank>.pt`` for the test to compare.
``tests/test_torch_port_dp.py`` does the same with ``run_dp``,
``tests/test_torch_port_ring.py`` with ``run_ring`` and
``tests/test_torch_port_tp.py`` with ``run_tp``. This module imports no
JAX.
"""

import contextlib
import dataclasses
import io
import os

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store_{world}",
                            world_size=world, rank=rank)
    try:
        _run(rank, world, work)
    finally:
        dist.destroy_process_group()


def _run(rank: int, world: int, work: str) -> None:
    from mclstexp_tpu_torch import config
    from mclstexp_tpu_torch.cli import main as cli
    from mclstexp_tpu_torch.data import st_dataset, synthetic
    from mclstexp_tpu_torch.infer import embed
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.ops.retrieval_sharded import sharded_retrieve_and_aggregate
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.parallel.mesh import make_mesh, shard_batch

    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {"world": distributed.world_size(), "rank": distributed.rank()}
    mesh = make_mesh(device="cpu")
    out["shard"] = distributed.process_shard(10)
    out["shard_batch"] = shard_batch({"even": np.arange(6 * world), "odd": np.arange(7)}, mesh)
    distributed.sync_hosts("test")

    out["retrieval"] = [
        sharded_retrieve_and_aggregate(mesh=mesh, return_matches=True, device="cpu", **case)
        for case in inputs["retrieval"]
    ]
    for case in inputs["retrieval"][:1]:
        empty = dict(case, key_mask=np.zeros(len(case["key_emb"]), bool))
        try:
            sharded_retrieve_and_aggregate(mesh=mesh, device="cpu", **empty)
            out["empty_mask"] = "no error"
        except ValueError as e:
            out["empty_mask"] = str(e)

    cfg = config.ModelConfig(**inputs["model_cfg"])
    model = MclSTExp(cfg, device="cpu")
    model.load_state_dict(inputs["state_dict"], strict=True)
    sections = synthetic.make_dataset(**inputs["sections"])
    out["embed"] = embed.compute_embeddings_sharded(model, sections, mesh, device="cpu",
                                                    **inputs["sweep"])

    # the CLI's cooperative pre-cut: this rank cuts its share, then all read
    cut = []
    cut_patches = st_dataset.cut_patches

    def counting_cut(slide, centers, patch_size, device):
        cut.append(len(centers))
        return cut_patches(slide, centers, patch_size, device)

    st_dataset.cut_patches = counting_cut
    tree = inputs["tree"]
    cfg = config.get_config("her2st")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_root=tree["root"], gene_panel=tree["panel"],
        patch_cache_dir=os.path.join(work, f"cache_{world}"), patch_size=tree["patch_size"]))
    loaded = cli._load_sections(cfg, device="cpu")
    out["cut"] = cut
    out["patches"] = [np.asarray(s.patches) for s in loaded]
    torch.save(out, os.path.join(work, f"result_{world}_{rank}.pt"))


# ------------------------------------------------------------------------
# The data-parallel training job (tests/test_torch_port_dp.py): each rank
# runs the port's training paths over the group and saves what it got to
# ``work/dp_result_<world>_<rank>.pt``.

def narrow_baseline(cfg, device="cuda", attn_backend="xla"):
    """``trainer.build_baseline`` at test widths: HisToGene (dim 32, one
    layer of 2 heads) and Hist2ST (fig 28, patch 7, channel 16, depths
    1 / 1 / 2, 2 heads), dropout 0.1 in both."""
    from mclstexp_tpu_torch.baselines import models, trainer

    if cfg.model == "histogene":
        return models.HisToGene(cfg.n_genes, cfg.patch_size, dim=32, n_layers=1, heads=2,
                                dropout=0.1, attn_backend=attn_backend, device=device)
    return models.Hist2ST(cfg.n_genes, fig_size=cfg.patch_size, patch_size=7, channel=16,
                          depth1=1, depth2=1, depth3=2, heads=2, dropout=0.1,
                          zinb=cfg.zinb_coef > 0, coef_head=trainer.resolve_bake(cfg) > 0,
                          attn_backend=attn_backend, device=device)


def dp_sections(spots, genes, patch, seed=0):
    """Synthetic sections of ``spots`` spots each (the port's
    ``make_section`` with shared gene loadings)."""
    from mclstexp_tpu_torch.data import synthetic

    loadings = np.random.default_rng(seed).normal(size=(4, genes))
    return [synthetic.make_section(f"S{i + 1}", n, genes, patch, seed=seed + 100 + i,
                                   gene_loadings=loadings) for i, n in enumerate(spots)]


def step_grads(kind: str, cfg, sections, batch_size: int, mesh=None):
    """The gradients one step takes on the first ``batch_size`` training
    spots of fold 0, from the initial parameters: the flagship step (kind
    "flagship", ``cfg`` a ``Config``) or BLEEP's ("bleep", a
    ``BaselineConfig``), over ``mesh``'s ranks (this rank's rows, as the
    loops give them) or, without one, in one process. The optimizer is SGD
    at lr 0, so the gradients stay on the parameters."""
    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.data.pipeline import ConcatSections, DeviceResidentData, split_fold
    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.parallel.mesh import batch_rows
    from mclstexp_tpu_torch.train.state import TrainState, create_train_state
    from mclstexp_tpu_torch.train.step import batch_shard, make_train_step

    train_secs, _ = split_fold(sections, 0)
    data = DeviceResidentData(ConcatSections.from_sections(train_secs), "cpu")
    idx = np.arange(batch_size)
    rows = slice(None) if mesh is None else batch_rows(batch_size, mesh)
    batch = data.take(idx, rows)
    shard = batch_shard(mesh, batch_size)
    generator = augment.reseed(torch.Generator(), 5, 0, 0)
    if kind == "flagship":
        model = create_train_state(cfg.model, cfg.train, "cpu").model
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
        draws = augment.sample_st_draws(generator, batch_size, "cpu")
        if shard is not None:
            draws = augment.take_rows(draws, shard.rows)
        make_train_step("st")(state, batch, draws, generator, shard)
    else:
        model = trainer.init_baseline(cfg, "cpu").model
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
        trainer.make_bleep_step(cfg)(state, batch, generator, shard)
    return {name: p.grad.clone() for name, p in model.named_parameters() if p.grad is not None}


def run_dp(rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/dp_store_{world}",
                            world_size=world, rank=rank)
    try:
        _run_dp(rank, world, work)
    finally:
        dist.destroy_process_group()


def _run_dp(rank: int, world: int, work: str) -> None:
    from mclstexp_tpu_torch.baselines import losses as bl
    from mclstexp_tpu_torch.baselines import trainer
    from mclstexp_tpu_torch.cli import main as cli
    from mclstexp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from mclstexp_tpu_torch.core.losses import symmetric_infonce_gathered
    from mclstexp_tpu_torch.models.image.common import BatchNormT, global_batch_stats
    from mclstexp_tpu_torch.train import checkpoint
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    inputs = torch.load(os.path.join(work, "dp_inputs.pt"), weights_only=False)
    group = dist.group.WORLD
    out = {}

    # (b) the gathered losses on this rank's rows, values and gradients
    per = len(inputs["spot"]) // world
    rows = slice(rank * per, (rank + 1) * per)
    for name, fn in (("infonce", symmetric_infonce_gathered),
                     ("bleep", bl.bleep_clip_loss_gathered)):
        spot = torch.tensor(inputs["spot"][rows], requires_grad=True)
        image = torch.tensor(inputs["image"][rows], requires_grad=True)
        loss = fn(spot, image, inputs["temperature"], group)
        loss.backward()
        out[f"gathered_{name}"] = (float(loss), spot.grad.numpy(), image.grad.numpy())

    # (c) the global batch norm on this rank's rows
    bn_in = inputs["bn"]
    per = len(bn_in["x"]) // world
    rows = slice(rank * per, (rank + 1) * per)
    bn = BatchNormT(bn_in["x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(bn_in["weight"]))
        bn.bias.copy_(torch.from_numpy(bn_in["bias"]))
    x = torch.tensor(bn_in["x"][rows], requires_grad=True)
    bn.train()
    with global_batch_stats(bn, group):
        y = bn(x)
    (y * torch.from_numpy(bn_in["upstream"][rows])).sum().backward()
    out["bn"] = dict(y=y.detach().numpy(), dx=x.grad.numpy(), dweight=bn.weight.grad.numpy(),
                     dbias=bn.bias.grad.numpy(), running_mean=bn.running_mean.numpy(),
                     running_var=bn.running_var.numpy(), group_after=bn.group)

    # only rank 0 writes: count the checkpoint writes of this rank
    writes = []
    write = checkpoint.write_checkpoint

    def counting_write(path, payload):
        writes.append(path)
        return write(path, payload)

    checkpoint.write_checkpoint = counting_write

    # (a) the flagship fold, resident and streamed; (d) resume at world 2
    fold = inputs["fold"]
    sections = dp_sections(**fold["sections"])

    def fold_cfg(tag, **train_kw):
        return Config(model=ModelConfig(**fold["model"]),
                      train=TrainConfig(**{**fold["train"], **train_kw,
                                           "checkpoint_dir": os.path.join(work, tag)}),
                      data=DataConfig(dataset="synthetic", patch_size=fold["patch"]))

    def run_fold(tag, resume=False, **train_kw):
        logger = MetricLogger(path=os.path.join(work, tag, "log.jsonl"), echo=False)
        state = train_fold(fold_cfg(tag, **train_kw), sections, 0, logger, device="cpu",
                           resume=resume)
        logger.close()
        losses = [(r["epoch"], r["step"], r["loss"]) for r in logger.records if "loss" in r]
        return dict(losses=losses, state=state.model.state_dict(), step=state.step,
                    optimizer=state.optimizer.state_dict(),
                    resumed=[r["epoch"] for r in logger.records if r.get("event") == "resume"])

    out["fold"] = run_fold(f"fold_{world}")
    out["stream"] = run_fold(f"stream_{world}", device_data_budget_bytes=0)
    if world == 2:
        out["whole"] = run_fold("whole", max_epochs=2)
        run_fold("split", max_epochs=1)
        out["resumed"] = run_fold("split", resume=True, max_epochs=2)
        # (h) a ("data", "model") mesh: the model ranks hold replicas
        out["model_axis"] = run_fold("model_axis", mesh_shape=(1, 2),
                                     mesh_axes=("data", "model"))

    # one step's gradients: a sharded batch of 6 and a replicated one of 5
    from mclstexp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    bleep = inputs["bleep"]
    out["grads"] = {
        (kind, b): step_grads(kind, cfg, dp_sections(**secs), b, mesh)
        for kind, cfg, secs in (("flagship", fold_cfg("grads"), fold["sections"]),
                                ("bleep", trainer.BaselineConfig(**bleep["cfg"]),
                                 bleep["sections"]))
        for b in (6, 5)}

    # (e) BLEEP with a mesh, (f) slide-DP over the group
    state = trainer.train_bleep_fold(trainer.BaselineConfig(**bleep["cfg"]),
                                     dp_sections(**bleep["sections"]), 0,
                                     logger=MetricLogger(echo=False), device="cpu", mesh=mesh)
    out["bleep"] = state.model.state_dict()
    trainer.build_baseline = narrow_baseline
    out["slide_dp"] = {}
    for family, case in inputs["slide_dp"].items():
        logger = MetricLogger(echo=False)
        state = trainer.train_baseline_fold(trainer.BaselineConfig(**case["cfg"]),
                                            dp_sections(**case["sections"]), 0, logger=logger,
                                            device="cpu", mesh=mesh)
        out["slide_dp"][family] = dict(losses=[r["loss"] for r in logger.records],
                                       state=state.model.state_dict(), step=state.step)
    out["writes"] = list(writes)

    # (g) the command line under the group (HisToGene at the narrow widths)
    if world == 2:
        cwd = os.getcwd()
        os.chdir(os.path.join(work, "cli"))
        try:
            common = ["--dataset", "synthetic", "--fold", "0", "--max_epochs", "1",
                      "--device", "cpu"]
            for name, argv in (("cli_train", ["train"]),
                               ("cli_baseline", ["baseline", "--baseline", "histogene", "--dp"])):
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    rc = cli.main(argv + common)
                out[name] = (rc, printed.getvalue())
        finally:
            os.chdir(cwd)
    torch.save(out, os.path.join(work, f"dp_result_{world}_{rank}.pt"))


# ------------------------------------------------------------------------
# The sequence- and tensor-parallel jobs (tests/test_torch_port_ring.py,
# tests/test_torch_port_tp.py): each rank saves what it got to
# ``work/<job>_result_<world>_<rank>.pt``.

def _run_job(job, rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/{job.__name__}_store_{world}",
                            world_size=world, rank=rank)
    try:
        inputs = torch.load(os.path.join(work, f"{job.__name__}_inputs.pt"), weights_only=False)
        out = job(rank, world, work, inputs)
        torch.save(out, os.path.join(work, f"{job.__name__}_result_{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def step_outcome(cfg, tcfg, batch, mesh=None, attn_backend="xla", tp=False):
    """One flagship step (augment "none", dropout from a generator seeded 3)
    from the initial parameters of ``cfg``: (loss, {name: gradient before
    Adam}, state_dict after Adam), tensors whole. Under ``mesh`` (a
    ("data", "seq") or ("data", "model") mesh) the rank takes its rows of
    the images (``batch_shard``) and runs inside ``active_mesh``; ``tp``
    places the parameters by ``parallel.tp.shard_train_state``."""
    from torch.distributed.tensor import DTensor

    from mclstexp_tpu_torch.ops import augment
    from mclstexp_tpu_torch.parallel import tp as tp_layouts
    from mclstexp_tpu_torch.parallel.mesh import active_mesh
    from mclstexp_tpu_torch.train.state import create_train_state
    from mclstexp_tpu_torch.train.step import batch_shard, make_train_step

    state = create_train_state(dataclasses.replace(cfg, attn_backend=attn_backend), tcfg, "cpu")
    if tp:
        state = tp_layouts.shard_train_state(state, mesh)
    shard = batch_shard(mesh, len(batch["expression"]))
    if shard is not None:
        batch = dict(batch, image_u8=batch["image_u8"][shard.rows])
    generator = augment.reseed(torch.Generator(), 3, 0, 0)
    with active_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        loss = make_train_step("none")(state, batch, None, generator, shard)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t.detach().clone()

    grads = {n: whole(p.grad) for n, p in state.model.named_parameters() if p.grad is not None}
    return float(loss), grads, {k: whole(v) for k, v in state.model.state_dict().items()}, state


def ring_job(rank: int, world: int, work: str, inputs: dict) -> dict:
    from mclstexp_tpu_torch.config import ModelConfig, TrainConfig
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.parallel.mesh import active_mesh, make_mesh
    from mclstexp_tpu_torch.parallel.ring_attention import ring_self_attention

    out = {}
    if world in (2, 3):
        # the function over the world group, this rank's blocks
        att = inputs["attention"]
        per = len(att["q"]) // world
        rows = slice(rank * per, (rank + 1) * per)
        q, k, v = (torch.tensor(att[name][rows], requires_grad=True) for name in "qkv")
        got = ring_self_attention(q, k, v, dist.group.WORLD)
        (got * torch.from_numpy(att["upstream"][rows])).sum().backward()
        out["ring"] = (got.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy())
        q16, k16, v16 = (torch.from_numpy(att[name][rows]).bfloat16() for name in "qkv")
        out["ring_bf16"] = ring_self_attention(q16, k16, v16, dist.group.WORLD).float().numpy()

        # the spot tower with "ring" under a (1, world) ("data", "seq") mesh
        mesh = make_mesh((1, world), ("data", "seq"), device="cpu")
        spots = inputs["spots"]
        model = MclSTExp(ModelConfig(**spots["cfg"], attn_backend="ring"), device="cpu")
        model.load_state_dict(spots["state_dict"], strict=True)
        expression, position = (torch.from_numpy(spots[k]) for k in ("expression", "position"))
        with torch.no_grad(), active_mesh(mesh):
            out["encode_spots"] = model.encode_spots(expression, position).numpy()
            try:  # 8 spots do not divide a ring of 3
                model.encode_spots(expression[:8], position[:8])
                out["undivided"] = "no error"
            except ValueError as e:
                out["undivided"] = str(e)
    step = inputs["step"]
    cfg, tcfg = ModelConfig(**step["cfg"]), TrainConfig(**step["train"])
    for shape in step["meshes"][world]:
        mesh = make_mesh(shape, ("data", "seq"), device="cpu")
        out[("step", shape)] = step_outcome(cfg, tcfg, step["batch"], mesh, "ring")[:3]
    return out


def tp_job(rank: int, world: int, work: str, inputs: dict) -> dict:
    from torch.distributed.tensor import DTensor

    from mclstexp_tpu_torch.config import ModelConfig, TrainConfig
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp
    from mclstexp_tpu_torch.parallel.mesh import make_mesh
    from mclstexp_tpu_torch.parallel.tp import shard_params
    from mclstexp_tpu_torch.train import checkpoint

    out = {}
    shape = (world // 2, 2)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    for tag, kw in inputs["layouts"].items():
        model = shard_params(MclSTExp(ModelConfig(**kw), device="cpu"), mesh)
        out[("layout", tag)] = {
            n: (tuple(p.placements), tuple(p.to_local().shape)) if isinstance(p, DTensor)
            else None for n, p in model.named_parameters()}
    tcfg = TrainConfig(**inputs["train"])
    for tag, kw in inputs["steps"].items():
        loss, grads, after, state = step_outcome(ModelConfig(**kw), tcfg, inputs["batch"], mesh,
                                                 tp=True)
        out[("step", tag)] = (loss, grads, after)
        ckpt = os.path.join(work, f"ckpt_{world}_{tag}")
        checkpoint.save_checkpoint_on_lead(ckpt, state)
        out[("ckpt", tag)] = ckpt
    return out


def run_ring(rank: int, world: int, work: str) -> None:
    _run_job(ring_job, rank, world, work)


def run_tp(rank: int, world: int, work: str) -> None:
    _run_job(tp_job, rank, world, work)
