"""The port's multi-process eval path against the JAX package, on the CPU:
process-group init, the mesh helpers, sharded retrieval, the sharded
embedding sweep, the CLI's cooperative patch-cache pre-cut and
``eval --shard-eval``.

* The merge and the row fetch of the sharded retrieval, run by
  ``simulate_shards`` over 1-8 slabs in this process, against JAX's
  ``sharded_retrieve_and_aggregate`` on a mesh of as many of the suite's 8
  CPU devices, and against the port's dense path.
* One gloo job at world size 2 and one at 3, each a set of processes
  started once for this module (``tests/_torch_port_gloo.py``; a
  ``FileStore`` rendezvous, no TCP port), run the real collectives:
  ``sharded_retrieve_and_aggregate`` against JAX's on a mesh of that many
  devices, ``compute_embeddings_sharded`` (150 spots, batch 8, image batch
  11: uneven splits) against the port's one-process sweep and JAX's,
  ``process_shard`` / ``sync_hosts`` / ``shard_batch``, and the pre-cut.

Tolerances: indices exact (ties to the lowest global index included);
scores within 1e-6; aggregates rtol 2e-5, atol 1e-6 (the JAX package's own
sharded-vs-dense pin); embeddings equal to the port's one-process sweep
bit for bit and within atol 1e-4 of JAX's (fp32 towers, sums in another
order, as ``test_torch_port_eval.py``); ``eval --shard-eval`` at world size
1 equal to ``eval``.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mclstexp_tpu.config import ModelConfig as JaxModelConfig
from mclstexp_tpu.config import TrainConfig as JaxTrainConfig
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.infer import embed as jax_embed
from mclstexp_tpu.ops.retrieval_sharded import (
    sharded_retrieve_and_aggregate as jax_sharded_retrieve,
)
from mclstexp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mclstexp_tpu.train.state import create_train_state as jax_create_train_state
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.cli import main as cli
from mclstexp_tpu_torch.data import st_dataset, synthetic
from mclstexp_tpu_torch.infer import embed
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import retrieval, retrieval_sharded
from mclstexp_tpu_torch.parallel import distributed

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
AGG_TOL = dict(rtol=2e-5, atol=1e-6)
WORLDS = (2, 3)
TINY = dict(encoder_name="tiny_cnn", image_dim=128, spot_dim=24, projection_dim=16,
            heads_num=2, heads_dim=8, head_layers=1)
SECTIONS = dict(num_sections=3, num_spots=50, num_genes=24, patch_size=16, seed=2)
SWEEP = dict(batch_size=8, image_batch_size=11)  # 18 + 13 full batches, tails of 6 and 7
TREE_SPOTS = (16, 20, 25)


def _case(seed, nk, nq, top_k, weight_ord, d=16, g=12, mask=None, ties=False, **kw):
    rng = np.random.default_rng(seed)
    key_emb = rng.normal(size=(nk, d)).astype(np.float32)
    if ties:  # duplicated keys score exactly alike: the lowest index must win
        key_emb[nk - 40:nk - 30] = key_emb[20:30]
    case = dict(key_emb=key_emb, key_expr=rng.normal(size=(nk, g)).astype(np.float32),
                query_emb=rng.normal(size=(nq, d)).astype(np.float32), top_k=top_k,
                weight_ord=weight_ord, key_mask=mask, **kw)
    if ties:  # queries equal to a duplicated key: its two copies tie at the top
        case["query_emb"][:5] = key_emb[20:25] * 2.0
    return case


def _loo_mask(nk, start, stop):
    mask = np.ones(nk, bool)
    mask[start:stop] = False
    return mask


def _cases():
    few = np.zeros(20, bool)
    few[[2, 5, 11, 19]] = True
    return [
        # LOO mask across slab boundaries, ties, 4 query chunks of 8
        _case(0, 333, 29, 7, 1, mask=_loo_mask(333, 60, 140), ties=True, query_chunk=8),
        # K clamped to the 4 active keys; slabs shorter than K
        _case(1, 20, 5, 50, 2, mask=few),
        # each slab through streaming_topk, BLEEP weights
        _case(2, 333, 17, 9, -1, ties=True, local_streaming=True, query_chunk=16),
        # uniform weights; the active count given
        _case(3, 101, 11, 5, 0, mask=_loo_mask(101, 0, 30), key_mask_count=71),
    ]


def _jax_reference(case, n_dev):
    return jax_sharded_retrieve(mesh=jax_make_mesh((n_dev,), ("data",)), return_matches=True,
                                **case)


def _check_against_jax(got, want, case):
    vals, idx, emb, expr = (np.asarray(t) for t in got)
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_allclose(vals, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(emb, want[2], **AGG_TOL)
    np.testing.assert_allclose(expr, want[3], **AGG_TOL)
    # and the port's dense path
    dense_emb, dense_expr = retrieval.retrieve_and_aggregate(
        case["key_emb"], case["key_expr"], case["query_emb"], case["top_k"],
        weight_ord=case["weight_ord"], key_mask=case["key_mask"], device="cpu")
    np.testing.assert_allclose(emb, dense_emb, **AGG_TOL)
    np.testing.assert_allclose(expr, dense_expr, **AGG_TOL)


def _simulate_shards(case, n_dev):
    """The sharded selection and aggregation over ``n_dev`` slabs in this
    process: the collectives become a concatenation in rank order and a sum."""
    def slabs(a, fill):
        s = -(-len(a) // n_dev)
        pad = torch.full((s * n_dev - len(a),) + tuple(a.shape[1:]), fill, dtype=a.dtype)
        return torch.cat([a, pad]), s

    k, s = slabs(torch.from_numpy(case["key_emb"]), 0.0)
    e, _ = slabs(torch.from_numpy(case["key_expr"]), 0.0)
    mask = case["key_mask"] if case["key_mask"] is not None else np.ones(len(k), bool)
    valid, _ = slabs(torch.from_numpy(np.asarray(mask[:len(case["key_emb"])])), False)
    q = torch.from_numpy(case["query_emb"])
    top_k = min(case["top_k"], int(valid.sum()))
    cands = [retrieval_sharded.local_topk(k[r * s:(r + 1) * s], valid[r * s:(r + 1) * s], q,
                                          min(top_k, s), bool(case.get("local_streaming")))
             for r in range(n_dev)]
    vals, idx = retrieval_sharded.merge_candidates(
        [v for v, _ in cands], [i + r * s for r, (_, i) in enumerate(cands)], top_k)
    sel_emb = sum(retrieval_sharded.owned_rows(k[r * s:(r + 1) * s], idx, r, s)
                  for r in range(n_dev))
    sel_expr = sum(retrieval_sharded.owned_rows(e[r * s:(r + 1) * s], idx, r, s)
                   for r in range(n_dev))
    return (vals, idx) + retrieval.aggregate_from_selected(sel_emb, sel_expr, q,
                                                           case["weight_ord"])


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_merge_and_fetch_over_simulated_shards_match_jax(n_dev):
    assert len(jax.devices()) >= 8
    for case in _cases():
        _check_against_jax(_simulate_shards(case, n_dev), _jax_reference(case, n_dev), case)
    with pytest.raises(ValueError, match="deactivates every"):
        jax_sharded_retrieve(mesh=jax_make_mesh((n_dev,), ("data",)),
                             **dict(_cases()[0], key_mask=np.zeros(333, bool)))


def test_merge_prefers_the_lowest_global_index():
    """Equal scores in two slabs: the merge keeps the earlier slab's key."""
    vals = [torch.tensor([[0.9, 0.5]]), torch.tensor([[0.9, 0.7]])]
    idx = [torch.tensor([[3, 1]]), torch.tensor([[7, 5]])]
    top, winners = retrieval_sharded.merge_candidates(vals, idx, 3)
    assert winners.tolist() == [[3, 7, 5]]
    np.testing.assert_array_equal(top, torch.tensor([[0.9, 0.9, 0.7]]))
    rows = torch.arange(12.0).reshape(6, 2)  # slab 1 of length 6 holds keys 6..11
    fetched = retrieval_sharded.owned_rows(rows, torch.tensor([[3, 7]]), rank=1, s_per_dev=6)
    assert fetched.tolist() == [[[0.0, 0.0], [2.0, 3.0]]]


def _jax_model():
    jax_sections = jax_synthetic.make_dataset(**SECTIONS)
    sample = {"image": np.zeros((1, 16, 16, 3), np.float32),
              "expression": jax_sections[0].expression[:1],
              "position": jax_sections[0].positions[:1].astype(np.int32)}
    model, state = jax_create_train_state(JaxModelConfig(**TINY), JaxTrainConfig(batch_size=8),
                                          sample)
    return jax_sections, model, state


def _write_tree(work):
    root = os.path.join(work, "her2st")
    _, gene_names = synthetic.write_st_layout(root, num_sections=len(TREE_SPOTS),
                                              num_spots=list(TREE_SPOTS), num_genes=12,
                                              seed=3)
    panel = os.path.join(work, "panel.npy")
    np.save(panel, np.array(gene_names[:10]))
    return dict(root=root, panel=panel, patch_size=16)


@pytest.fixture(scope="module")
def gloo_job(tmp_path_factory):
    """Both jobs at once, every rank a process of its own; returns the
    inputs, each rank's results and the references."""
    work = str(tmp_path_factory.mktemp("gloo"))
    jax_sections, jm, jstate = _jax_model()
    params, stats = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    cfg = config.ModelConfig(**TINY)
    inputs = dict(retrieval=_cases(), model_cfg=TINY, sections=SECTIONS, sweep=SWEEP,
                  state_dict=params_from_jax(params, stats, cfg), tree=_write_tree(work))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import _torch_port_gloo; _torch_port_gloo.run({r}, {w}, {work!r})"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for w in WORLDS for r in range(w)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = {w: [torch.load(os.path.join(work, f"result_{w}_{r}.pt"), weights_only=False)
                   for r in range(w)] for w in WORLDS}
    return dict(inputs=inputs, results=results, jax_model=(jax_sections, jm, jstate))


@pytest.mark.parametrize("world", WORLDS)
def test_process_shard_sync_and_shard_batch(gloo_job, world):
    ranks = gloo_job["results"][world]
    per = -(-10 // world)
    for r, out in enumerate(ranks):
        assert (out["world"], out["rank"]) == (world, r)
        assert out["shard"] == slice(r * per, min((r + 1) * per, 10))
        np.testing.assert_array_equal(out["shard_batch"]["even"], np.arange(6 * r, 6 * r + 6))
        np.testing.assert_array_equal(out["shard_batch"]["odd"], np.arange(7))  # replicated
    covered = np.concatenate([np.arange(10)[out["shard"]] for out in ranks])
    np.testing.assert_array_equal(covered, np.arange(10))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_retrieval_matches_jax(gloo_job, world):
    first = gloo_job["results"][world][0]["retrieval"]
    for r, out in enumerate(gloo_job["results"][world]):
        assert out["empty_mask"] == "key_mask deactivates every retrievable key"
        for c, (case, got) in enumerate(zip(gloo_job["inputs"]["retrieval"], out["retrieval"])):
            _check_against_jax(got, _jax_reference(case, world), case)
            for a, b in zip(got, first[c]):  # every rank returns the same arrays
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sweep_matches_one_process_and_jax(gloo_job, world):
    inputs = gloo_job["inputs"]
    model = MclSTExp(config.ModelConfig(**TINY), device="cpu")
    model.load_state_dict(inputs["state_dict"], strict=True)
    sections = synthetic.make_dataset(**SECTIONS)
    img1, spot1 = embed.compute_embeddings(model, sections, device="cpu", **SWEEP)
    jax_sections, jm, jstate = gloo_job["jax_model"]
    jimg, jspot = jax_embed.compute_embeddings(jm, jstate.params, jstate.batch_stats,
                                               jax_sections, 8)
    for out in gloo_job["results"][world]:
        img, spot = out["embed"]
        assert img.shape == img1.shape == (150, 16) and spot.shape == spot1.shape
        np.testing.assert_array_equal(img, img1)
        np.testing.assert_array_equal(spot, spot1)
        np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-4)
        np.testing.assert_allclose(spot, jspot, rtol=0, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_cooperative_precut(gloo_job, world):
    """Each rank cuts only its share of the sections into the shared cache;
    after the barrier every rank reads every section from it."""
    tree = gloo_job["inputs"]["tree"]
    ranks = gloo_job["results"][world]
    per = -(-len(TREE_SPOTS) // world)
    for r, out in enumerate(ranks):
        assert out["cut"] == list(TREE_SPOTS[r * per:(r + 1) * per])
    want = st_dataset.load_her2st(tree["root"], list(np.load(tree["panel"])),
                                  patch_size=tree["patch_size"], device="cpu")
    for out in ranks:
        for got, section in zip(out["patches"], want):
            np.testing.assert_array_equal(got, section.patches)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialization_paths(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not distributed.is_initialized()
    assert distributed.maybe_initialize_distributed(device="cpu") is False  # no-op
    assert not distributed.is_initialized() and distributed.world_size() == 1
    assert distributed.process_shard(7) == slice(0, 7)
    distributed.sync_hosts()  # no group: returns
    with pytest.raises(ValueError, match="--process-id"):
        distributed.maybe_initialize_distributed("127.0.0.1:1", 2, 5, device="cpu")
    try:
        port = _free_port()
        assert distributed.maybe_initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                                        device="cpu") is False
        assert distributed.is_initialized() and torch.distributed.get_backend() == "gloo"
        assert distributed.maybe_initialize_distributed(device="cpu") is False  # joined
        distributed.sync_hosts("one rank")
    finally:
        distributed.shutdown()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert distributed.maybe_initialize_distributed(device="cpu") is False
        assert distributed.world_size() == 1 and distributed.rank() == 0
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device("cuda") == "cuda:3"
    assert distributed.local_device("cuda:1") == "cuda:1"
    assert distributed.local_device("cpu") == "cpu"


def test_eval_shard_eval_at_world_one_equals_eval(tmp_path, monkeypatch, capsys):
    """Without torchrun ``--shard-eval`` runs over a one-rank group (made and
    destroyed by the command) and scores exactly as ``eval``. ``train`` and
    ``baseline``, which refused a group before data-parallel training was
    ported, now train over one: ``train`` in a one-rank group joined by the
    explicit flags takes the data-parallel step (the group's mesh) and
    writes fold 0's checkpoint, and ``baseline --dp`` makes and destroys its
    own one-rank group (tests/test_torch_port_dp.py holds both to one
    process at world size 2)."""
    monkeypatch.chdir(tmp_path)
    common = ["--dataset", "synthetic", "--device", "cpu"]
    assert cli.main(["train", "--max_epochs", "1"] + common) == 0  # the three folds
    assert cli.main(["eval", "--json", "eval.json"] + common) == 0
    dumps = sorted((tmp_path / "prediction_result").rglob("*.npy"))
    assert len(dumps) == 3
    want_pred = [np.load(p) for p in dumps]
    for p in dumps:
        p.unlink()
    assert not distributed.is_initialized()
    assert cli.main(["eval", "--shard-eval", "--json", "shard.json"] + common) == 0
    assert "rank 0 of world size 1 on cpu" in capsys.readouterr().err
    assert not distributed.is_initialized()
    with open("eval.json") as f, open("shard.json") as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(got["per_fold"]) == 3
    for p, w in zip(dumps, want_pred):  # rank 0 writes the dumps
        np.testing.assert_array_equal(np.load(p), w)

    from mclstexp_tpu_torch.train import loop

    meshes = []
    fold = loop.train_fold

    def seen(*args, **kw):
        state = fold(*args, **kw)
        meshes.append(loop.train_mesh(None, ("data",), "cpu"))
        return state

    monkeypatch.setattr(loop, "train_fold", seen)
    ckpt = tmp_path / "dp" / "synthetic" / "S1" / "best_0" / "state.pt"
    assert cli.main(["train", "--fold", "0", "--max_epochs", "1", "--checkpoint-dir", "dp",
                     "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
                     "--process-id", "0"] + common) == 0
    assert not distributed.is_initialized() and ckpt.exists()
    assert [m.mesh_dim_names for m in meshes] == [("data",)]
    capsys.readouterr()
    assert cli.main(["baseline", "--baseline", "histogene", "--n-layers", "1", "--dp",
                     "--max_epochs", "1", "--checkpoint-dir", "dp"] + common) == 0
    assert not distributed.is_initialized()
    out = capsys.readouterr().out
    scores = json.loads(out[out.index("{\n"):])
    assert sorted(scores) == ["heg_pcc", "hvg_pcc", "mae", "mse"]
    assert (tmp_path / "dp" / "baselines" / "histogene" / "best_0" / "state.pt").exists()


class _Joined(Exception):
    pass


def test_dist_flags_on_the_jax_subcommands(monkeypatch):
    """The same seven subcommands as in JAX take the multi-process flags and
    hand them to ``maybe_initialize_distributed`` at entry."""
    seen = []

    def join(coordinator, num_processes, process_id, device):
        seen.append((coordinator, num_processes, process_id, device))
        raise _Joined

    monkeypatch.setattr(distributed, "maybe_initialize_distributed", join)
    extra = {"predict": ["--checkpoint", "c", "--fold", "0"], "serve": ["--checkpoint", "c"],
             "export-torch": ["--checkpoint", "c", "--out", "o"],
             "baseline": ["--baseline", "bleep"]}
    for cmd in ("hvg", "train", "eval", "predict", "serve", "export-torch", "baseline"):
        with pytest.raises(_Joined):
            cli.main([cmd, "--coordinator", "h:1", "--num-processes", "2", "--process-id",
                      "1", "--device", "cpu"] + extra.get(cmd, []))
    assert seen == [("h:1", 2, 1, "cpu")] * 7
