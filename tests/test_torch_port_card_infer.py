"""The port's retrieval, serving and analysis paths on the card.

These tests need an NVIDIA card and skip without one:

    python -m pytest --noconftest tests/test_torch_port_card_infer.py -m gpu

The her2st flagship's fold 0 (three synthetic sections of 225 spots) is
trained once and its checkpoint loaded into a model with "flash" attention:
the eval sweep and every LOO fold (host and device metrics, the card's top-K
against the CPU's); a her2st-scale database behind ``PredictionService`` and
its HTTP server; the tutorial and the clustering analysis against the CPU;
the sharded retrieval over a one-rank NCCL group against the dense one.
"""

import base64
import dataclasses
import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_port_card import card, flagship_sections, reset_counts, shear_launches  # noqa: F401
from mclstexp_tpu_torch.config import her2st_config
from mclstexp_tpu_torch.infer import cluster, embed, evaluate, metrics
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import retrieval
from mclstexp_tpu_torch.ops.flash_attention import flash_attention
from mclstexp_tpu_torch.ops.row_shift import row_shift
from mclstexp_tpu_torch.train import checkpoint
from mclstexp_tpu_torch.train.loop import train_fold
from mclstexp_tpu_torch.utils.logging import MetricLogger

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def fold(card, tmp_path_factory):
    """(config, sections, checkpoint dir) of fold 0 at the her2st widths."""
    cfg = her2st_config(str(tmp_path_factory.mktemp("model_result")))
    sections = flagship_sections(cfg)
    train_fold(cfg, sections, fold=0, logger=MetricLogger(echo=False), device="cuda")
    saved = checkpoint.fold_checkpoint_dir(cfg.train.checkpoint_dir, cfg.data.dataset,
                                           sections[0].name, 0)
    return cfg, sections, saved


def _loaded(cfg, saved, backend):
    model = MclSTExp(dataclasses.replace(cfg.model, attn_backend=backend), device="cuda")
    checkpoint.load_checkpoint(saved, model)
    return model


@pytest.fixture(scope="module")
def flash_model(fold):
    cfg, _, saved = fold
    return _loaded(cfg, saved, "flash")


def _metrics_agree(host, dev):
    for k in host:
        assert math.isfinite(host[k]) and math.isfinite(dev[k]), (k, host[k], dev[k])
        assert math.isclose(host[k], dev[k], rel_tol=1e-4, abs_tol=1e-5), (k, host[k], dev[k])


def test_eval_sweep_and_loo_folds(fold, flash_model):
    """The B=32 sweep with "flash": head_layers x ceil(N/32) launches, finite
    embeddings, the spot embeddings within 1e-5 of the "xla" model's; every
    LOO fold's host and device metrics finite and within rtol 1e-4; the
    card's top-K indices identical to the CPU's on at least 99% of rows."""
    cfg, sections, saved = fold
    m, ev = cfg.model, cfg.eval
    n = sum(s.num_spots for s in sections)
    prepared = embed.prepare_eval_arrays(sections, device="cuda")
    reset_counts()
    img, spot = embed.compute_embeddings(flash_model, sections, ev.batch_size, prepared=prepared,
                                         as_device=True, device="cuda")
    torch.cuda.synchronize()
    assert flash_attention.launches == m.head_layers * -(-n // ev.batch_size)
    for e in (img, spot):
        assert e.shape == (n, m.projection_dim) and torch.isfinite(e).all()
    _, spot_xla = embed.compute_embeddings(_loaded(cfg, saved, "xla"), sections, ev.batch_size,
                                           prepared=prepared, as_device=True, tower="spot",
                                           device="cuda")
    assert float((spot - spot_xla).abs().max()) <= 1e-5

    bounds = evaluate.section_bounds([s.num_spots for s in sections])
    same_rows = 0
    for f, (start, stop) in enumerate(bounds):
        args = (f, img, spot, prepared["eval_expression"], bounds, sections[f].eval_expression,
                ev.top_k, ev.weight_ord)
        _metrics_agree(evaluate.evaluate_fold_resident(*args, device="cuda"),
                       evaluate.evaluate_fold_resident(*args, device_metrics=True,
                                                       device="cuda"))
        mask = np.ones(n, bool)
        mask[start:stop] = False
        k_eff = min(ev.top_k, int(mask.sum()))
        _, idx_card = retrieval.find_matches(spot, img[start:stop], k_eff,
                                             torch.from_numpy(mask).cuda())
        _, idx_cpu = retrieval.find_matches(spot.cpu(), img[start:stop].cpu(), k_eff,
                                            torch.from_numpy(mask))
        same_rows += int((idx_card.cpu() == idx_cpu).all(dim=1).sum())
    assert same_rows >= 0.99 * n, (same_rows, n)


def test_service_at_her2st_scale_and_its_http_server(fold, flash_model):
    """``PredictionService`` over a 32-section her2st-scale database (15,499
    spots): head_layers x ceil(N/32) launches to build it; one LOO fold of
    random-patch queries with host and device metrics agreeing; the server on
    127.0.0.1:0: /healthz, /predict of 1 (JSON lists), 37 and 256 patches
    (base64) and /embed of 8, each equal to the service's own answer, and a
    malformed body answered 400; the server thread joins."""
    from mclstexp_tpu_torch.data import synthetic
    from mclstexp_tpu_torch.infer import serve

    cfg = fold[0]
    m, ev, patch = cfg.model, cfg.eval, cfg.data.patch_size
    db = synthetic.make_spot_database(m.spot_dim)
    n = sum(s.num_spots for s in db)
    reset_counts()
    service = serve.PredictionService.from_sections(
        flash_model, db, batch_size=ev.batch_size, top_k=ev.top_k, weight_ord=ev.weight_ord,
        max_batch=256, patch_size=patch, device="cuda")
    torch.cuda.synchronize()
    assert flash_attention.launches == m.head_layers * -(-n // ev.batch_size)

    rng = np.random.default_rng(11)
    stop = db[0].num_spots
    queries = service.embed_patches(
        rng.integers(0, 256, size=(stop, patch, patch, 3), dtype=np.uint8))
    img = torch.zeros_like(service.key_emb)
    img[:stop] = torch.from_numpy(queries).cuda()
    args = (0, img, service.key_emb, service.key_expr,
            evaluate.section_bounds([s.num_spots for s in db]), db[0].eval_expression,
            ev.top_k, ev.weight_ord)
    _metrics_agree(evaluate.evaluate_fold_resident(*args, device="cuda"),
                   evaluate.evaluate_fold_resident(*args, device_metrics=True, device="cuda"))

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
        assert r.status == 200 and info["num_keys"] == n and info["top_k"] == ev.top_k, info
        for count, b64 in ((1, False), (37, True), (256, True)):
            patches = rng.integers(0, 256, size=(count, patch, patch, 3), dtype=np.uint8)
            if b64:
                body = {"patches_b64": base64.b64encode(patches.tobytes()).decode(),
                        "shape": list(patches.shape), "b64": True}
            else:
                body = {"patches": patches.tolist()}
            status, out = post("/predict", body)
            got = result(out)
            assert status == 200 and got.shape == (count, m.spot_dim) and np.isfinite(got).all()
            assert float(np.abs(got - service.predict(patches)).max()) <= 1e-6, count
        patches = rng.integers(0, 256, size=(8, patch, patch, 3), dtype=np.uint8)
        status, out = post("/embed", {"patches_b64": base64.b64encode(patches.tobytes()).decode(),
                                      "shape": list(patches.shape), "b64": True})
        assert status == 200 and result(out).shape == (8, m.projection_dim)
        assert float(np.abs(result(out) - service.embed_patches(patches)).max()) <= 1e-6
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/predict", {"patches_b64": "AAAA", "shape": [1, patch, patch, 3]})
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    assert not thread.is_alive()


def test_tutorial_and_its_clustering(card, tmp_path):
    """The tutorial on the card (two epochs: row_shift's Paeth shears in
    every step, the sweep, the fold's prediction, the gene ranking, domain
    clustering): a finite (64, 32) prediction and metrics, every gene ranked
    by descending -log10 p with the NaNs last; ``cluster_predictions`` and
    k-means on its prediction equal to the CPU's."""
    from mclstexp_tpu_torch import tutorial
    from mclstexp_tpu_torch.data.pipeline import num_train_steps

    reset_counts()
    out = tutorial.main(str(tmp_path / "tutorial"), max_epochs=2, device="cuda")
    torch.cuda.synchronize()
    steps = 2 * num_train_steps(2 * 64, 32)  # two 64-spot training sections, batch 32
    assert dict(row_shift.kernel_launches) == shear_launches(steps)
    pred, ranking = out["pred"], out["ranking"]
    assert pred.shape == (64, 32) and np.isfinite(pred).all()
    assert all(math.isfinite(v) for v in out["metrics"].values()), out["metrics"]
    logp = np.asarray(ranking["mean_neglog10_p"])
    finite = logp[np.isfinite(logp)]
    assert sorted(ranking["gene"]) == sorted(f"GENE{i}" for i in range(32))
    assert (np.diff(finite) <= 0).all() and np.isnan(logp[len(finite):]).all()

    labels = out["labels"]
    card_labels, _ = cluster.kmeans(cluster.pca(pred, 9, 0, "cuda"), 2, 0, "cuda")
    host_labels, _ = cluster.kmeans(cluster.pca(pred, 9, 0, "cpu"), 2, 0, "cpu")
    assert metrics.cluster_predictions(pred, labels, device="cuda") == \
        metrics.cluster_predictions(pred, labels, device="cpu")
    assert (card_labels == host_labels).all()


BLOBS = (600, 785, 6)  # her2st width: spots, genes, domains


def test_clustering_of_domains_at_her2st_width(card):
    """Seed-made domains (6 centers 8 apart per gene, unit noise; every 50th
    spot "undetermined"): ``cluster_predictions`` on the card equal to the
    CPU's with ARI 1, and the card's PCA + k-means labels the CPU's."""
    n, g, k = BLOBS
    rng = np.random.default_rng(15)
    y = rng.integers(0, k, size=n)
    x = (8.0 * rng.normal(size=(k, g))[y] + rng.normal(size=(n, g))).astype(np.float32)
    labels = np.array([f"domain{v}" for v in y], dtype=object)
    labels[::50] = "undetermined"
    keep = labels != "undetermined"
    card_scores = metrics.cluster_predictions(x, labels, device="cuda")
    assert card_scores == metrics.cluster_predictions(x, labels, device="cpu")
    assert card_scores["ari"] == 1.0
    card_labels, _ = cluster.kmeans(cluster.pca(x[keep], 9, 0, "cuda"), k, 0, "cuda")
    host_labels, _ = cluster.kmeans(cluster.pca(x[keep], 9, 0, "cpu"), k, 0, "cpu")
    assert (card_labels == host_labels).all()


def test_randomized_pca_on_a_flat_spectrum(card):
    """A flat spectrum (weak domain centers over unit noise) at her2st's
    width takes scikit-learn's randomized solver: float32 scores on the card
    within 1e-3 of the largest of the CPU's; the clustering equal."""
    rs = np.random.RandomState(3)
    y = rs.randint(0, BLOBS[2], size=BLOBS[0])
    flat = (0.3 * rs.normal(size=(BLOBS[2], BLOBS[1]))[y]
            + rs.normal(size=BLOBS[:2])).astype(np.float32)
    flat_labels = np.array([f"domain{v}" for v in y], dtype=object)
    assert cluster.pca_solver(flat.shape, 9) == "randomized"
    host_pca = cluster.pca(flat, 9, 0, "cpu").numpy()
    card_pca = cluster.pca(flat, 9, 0, "cuda").cpu().numpy()
    assert card_pca.dtype == np.float32
    assert float(np.abs(card_pca - host_pca).max() / np.abs(host_pca).max()) <= 1e-3
    assert metrics.cluster_predictions(flat, flat_labels, device="cuda") == \
        metrics.cluster_predictions(flat, flat_labels, device="cpu")


def test_sharded_retrieval_matches_dense(card):
    """``sharded_retrieve_and_aggregate`` over a one-rank NCCL group at the
    served fold's her2st scale (568 queries, 15,499 keys of which 14,931
    active, K=200, 256 / 785 wide, one query chunk of the fold's size)
    against ``retrieve_and_aggregate`` on the same inputs: indices identical,
    aggregates within 1e-6; the group destroyed after."""
    from mclstexp_tpu_torch.ops.retrieval_sharded import sharded_retrieve_and_aggregate
    from mclstexp_tpu_torch.parallel import distributed
    from mclstexp_tpu_torch.parallel.mesh import make_mesh

    nq, nk, k = 568, 15499, 200
    rng = np.random.default_rng(16)
    keys = rng.normal(size=(nk, 256)).astype(np.float32)
    expr = rng.normal(size=(nk, 785)).astype(np.float32)
    queries = rng.normal(size=(nq, 256)).astype(np.float32)
    mask = np.ones(nk, bool)
    mask[:nq] = False  # the held-out section
    try:
        _, idx, emb, pred = sharded_retrieve_and_aggregate(
            keys, expr, queries, k, make_mesh(device="cuda"), key_mask=mask,
            return_matches=True, device="cuda", query_chunk=nq)
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()
    want_emb, want_pred = retrieval.retrieve_and_aggregate(keys, expr, queries, k, key_mask=mask,
                                                           device="cuda")
    _, want_idx = retrieval.find_matches(torch.from_numpy(keys).cuda(),
                                         torch.from_numpy(queries).cuda(), k,
                                         key_mask=torch.from_numpy(mask).cuda())
    assert np.array_equal(idx, want_idx.cpu().numpy())
    assert max(float(np.abs(emb - want_emb).max()), float(np.abs(pred - want_pred).max())) <= 1e-6
