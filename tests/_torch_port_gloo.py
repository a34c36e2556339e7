"""One rank of the port's multi-process test job (gloo, on the CPU).

``tests/test_torch_port_sharded.py`` starts ``world`` processes on
``run``; each joins a gloo group through a ``FileStore`` under ``work``
(no TCP port, so parallel test workers cannot collide), runs the sharded
paths on the inputs the test wrote to ``work/inputs.pt`` and saves what it
got to ``work/result_<world>_<rank>.pt`` for the test to compare. This
module imports no JAX.
"""

import dataclasses
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
