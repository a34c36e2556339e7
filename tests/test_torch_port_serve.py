"""The serving path: ``PredictionService`` and its HTTP layer in the port,
against the JAX package's service with the same weights, on the CPU.

Tolerances: embeddings atol 1e-4 (fp32 towers, sums in another order);
predictions rtol 1e-4, since the embedding differences reach the 1/d^2
weights (the selection itself is the same); bucket padding is exact (the
same bucket shape either way, eval-mode BatchNorm).
"""

import base64
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mclstexp_tpu import config as jax_config
from mclstexp_tpu.data import synthetic as jax_synthetic
from mclstexp_tpu.infer import serve as jax_serve
from mclstexp_tpu.models.mclstexp import MclSTExp as JaxMclSTExp
from mclstexp_tpu_torch import config
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.infer import embed, serve
from mclstexp_tpu_torch.interop import params_from_jax
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops.retrieval import retrieve_and_aggregate

torch.set_num_threads(1)

EMB_TOL = dict(rtol=0, atol=1e-4)
PRED_TOL = dict(rtol=1e-4, atol=0)
TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, head_layers=1, pos_vocab=64, dense_block_impl="concat",
            attn_backend="flash")
KW = dict(top_k=8, weight_ord=1, max_batch=32)


@pytest.fixture(scope="module")
def services():
    jax_sections = jax_synthetic.make_dataset(num_sections=3, num_spots=50, num_genes=24,
                                              patch_size=16, seed=3)
    sections = synthetic.make_dataset(num_sections=3, num_spots=50, num_genes=24,
                                      patch_size=16, seed=3)
    jm = JaxMclSTExp(jax_config.ModelConfig(**TINY))
    sample = {"image": jax_sections[0].patches[:2].astype(np.float32) / 255.0,
              "expression": jax_sections[0].expression[:2],
              "position": jax_sections[0].positions[:2]}
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), sample, train=False))
    cfg = config.ModelConfig(**TINY)
    tm = MclSTExp(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"], cfg), strict=True)
    jservice = jax_serve.PredictionService.from_sections(
        jm, v["params"], v["batch_stats"], jax_sections, batch_size=32, **KW)
    service = serve.PredictionService.from_sections(tm, sections, batch_size=32, device="cpu",
                                                    **KW)
    return dict(sections=sections, jm=jm, v=v, tm=tm, jservice=jservice, service=service,
                jax_sections=jax_sections)


def test_bucket_size_matches_jax():
    for max_batch in (1, 7, 32, 200, 256):
        for n in range(1, 300):
            assert serve._bucket_size(n, max_batch) == jax_serve._bucket_size(n, max_batch)
    assert serve._bucket_size(150, 200) == 200  # the cap wins over the power of two


def test_database_matches_jax(services):
    s, js = services["service"], services["jservice"]
    np.testing.assert_allclose(s.key_emb.numpy(), np.asarray(js.key_emb), **EMB_TOL)
    np.testing.assert_array_equal(s.key_expr.numpy(), np.asarray(js.key_expr))
    assert s.info() == js.info()
    assert s.num_keys == 150 and s.num_genes == 24


@pytest.mark.parametrize("n", [1, 6, 37])
def test_predict_and_embed_match_jax(services, n):
    """37 patches take two tower calls at max_batch 32 (32, then 5 padded
    to a bucket of 8)."""
    patches = services["sections"][2].patches[:n]
    np.testing.assert_allclose(services["service"].embed_patches(patches),
                               services["jservice"].embed_patches(patches), **EMB_TOL)
    got = services["service"].predict(patches)
    assert got.shape == (n, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, services["jservice"].predict(patches), **PRED_TOL)


def test_service_scales_uint8_like_the_jitted_jax_service(services, monkeypatch):
    """The float32 batch that reaches ``encode_image`` is bit-equal, for all
    256 uint8 values, to the JAX service's ``/ 255`` as XLA compiles it (a
    multiplication by float32(1/255)): the same patch gives the service and
    ``compute_embeddings`` the same input bits."""
    patches = np.resize(np.arange(256, dtype=np.uint8), (2, 16, 16, 3))
    seen, encode = [], MclSTExp.encode_image

    def spy(model, x):
        seen.append(x.clone())
        return encode(model, x)

    monkeypatch.setattr(MclSTExp, "encode_image", spy)
    services["service"].embed_patches(patches)
    want = np.asarray(jax.jit(lambda u: u.astype(jnp.float32) / 255.0)(jnp.asarray(patches)))
    assert len(seen) == 1 and seen[0].dtype == torch.float32
    np.testing.assert_array_equal(seen[0].numpy(), want)
    sweep_input = embed._image_input(torch.from_numpy(patches), False, False, 0, 0)
    np.testing.assert_array_equal(sweep_input.numpy(), want)


def test_bucket_padding_is_exact(services):
    service = services["service"]
    patches = services["sections"][1].patches[:4]
    e4 = service.embed_patches(patches)
    np.testing.assert_array_equal(service.embed_patches(patches[:3]), e4[:3])
    big = service.embed_patches(services["sections"][1].patches[:40])
    assert big.shape == (40, 32)
    np.testing.assert_allclose(big[:4], e4, atol=1e-6)


def test_predict_is_retrieval_over_the_database(services):
    service = services["service"]
    patches = services["sections"][0].patches[:5]
    q = service.embed_patches(patches)
    _, want = retrieve_and_aggregate(service.key_emb, service.key_expr, q, top_k=service.top_k,
                                     weight_ord=service.weight_ord, device="cpu")
    np.testing.assert_array_equal(service.predict(patches), want)


def test_exclude_section_masks_after_joint_embedding(services):
    """The held-out section is masked after all sections are embedded
    together (the same keys as the full database), as in the JAX service."""
    service = services["service"]
    loo = serve.PredictionService.from_sections(services["tm"], services["sections"],
                                                batch_size=32, exclude_section=1, device="cpu",
                                                **KW)
    jloo = jax_serve.PredictionService.from_sections(
        services["jm"], services["v"]["params"], services["v"]["batch_stats"],
        services["jax_sections"], batch_size=32, exclude_section=1, **KW)
    torch.testing.assert_close(loo.key_emb, service.key_emb, rtol=0, atol=0)
    mask = loo.key_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(jloo.key_mask))
    assert not mask[50:100].any() and mask[:50].all() and mask[100:].all()
    assert loo.info()["num_active_keys"] == 100
    patches = services["sections"][1].patches[:5]
    np.testing.assert_allclose(loo.predict(patches), jloo.predict(patches), **PRED_TOL)
    with pytest.raises(ValueError, match="out of range"):
        serve.PredictionService.from_sections(services["tm"], services["sections"],
                                              exclude_section=3, device="cpu")


def test_validation(services):
    service, tm = services["service"], services["tm"]
    patches = services["sections"][0].patches
    with pytest.raises(ValueError, match="uint8"):
        service.embed_patches(patches[:2].astype(np.float32))
    with pytest.raises(ValueError, match="NHWC"):
        service.embed_patches(patches[0])
    with pytest.raises(ValueError, match="empty batch"):
        service.predict(patches[:0])
    with pytest.raises(ValueError, match="database size"):
        serve.PredictionService(tm, np.zeros((4, 32), np.float32), np.zeros((5, 24), np.float32),
                                device="cpu")
    with pytest.raises(ValueError, match="every database row"):
        serve.PredictionService(tm, np.ones((4, 32), np.float32), np.ones((4, 24), np.float32),
                                key_mask=np.zeros(4, bool), device="cpu")
    small = serve.PredictionService(tm, service.key_emb[:5], service.key_expr[:5], top_k=200,
                                    device="cpu")
    assert small.top_k == 5  # K clamps to the database
    pinned = serve.PredictionService(tm, service.key_emb, service.key_expr, patch_size=16,
                                     device="cpu")
    assert pinned.embed_patches(patches[:2]).shape == (2, 32)
    with pytest.raises(ValueError, match="training patch size"):
        pinned.embed_patches(np.zeros((2, 16, 8, 3), np.uint8))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def test_http_roundtrip(services):
    service = services["service"]
    patches = services["sections"][0].patches[:3]
    server = serve.make_server(service, port=0)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert _get(f"{base}/healthz") == service.info() == _get(f"{base}/info")
        want = service.predict(patches)
        out = _post(f"{base}/predict", {"patches_b64": base64.b64encode(patches.tobytes()).decode(),
                                        "shape": list(patches.shape), "b64": True})
        got = np.frombuffer(base64.b64decode(out["result_b64"]), np.float32).reshape(out["shape"])
        np.testing.assert_array_equal(got, want)
        out = _post(f"{base}/predict", {"patches": patches.tolist()})
        np.testing.assert_array_equal(np.asarray(out["result"], np.float32), want)
        out = _post(f"{base}/embed", {"patches": patches.tolist()})
        np.testing.assert_array_equal(np.asarray(out["result"], np.float32),
                                      service.embed_patches(patches))

        for bad in ({}, {"patches_b64": "AAAA", "shape": [1, 16, 16, 3]},
                    {"patches_b64": base64.b64encode(patches.tobytes()).decode()},
                    {"patches": [[1, 2], [3]]}):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(f"{base}/predict", bad)
            assert exc.value.code == 400
            assert "error" in json.loads(exc.value.read())
        req = urllib.request.Request(f"{base}/predict", data=b"{not json", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{base}/nope", {})
        assert exc.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{base}/nope")
        assert exc.value.code == 404

        orig = service.predict
        service.predict = lambda p: (_ for _ in ()).throw(RuntimeError("kernel boom"))
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(f"{base}/predict", {"patches": patches.tolist()})
            assert exc.value.code == 500
            assert "kernel boom" in json.loads(exc.value.read())["error"]
        finally:
            service.predict = orig
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=5)


def test_concurrent_requests_do_not_interleave_on_the_device(services):
    """Twelve client threads at once (more than the cores), each request on a
    handler thread of its own, with a short thread switch interval: every
    answer equals the serial one, and the image tower runs on the service's
    one worker thread, never entered by two requests at a time."""
    service = services["service"]
    model = service.model
    inside, most, threads = [0], [0], set()
    orig = model.encode_image

    def encode_image(x):
        threads.add(threading.current_thread().name)
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        time.sleep(0.01)
        try:
            return orig(x)
        finally:
            inside[0] -= 1

    patches = [services["sections"][i % 3].patches[i:2 * i + 2] for i in range(12)]
    want = [service.predict(p) for p in patches]
    model.encode_image = encode_image
    server = serve.make_server(service, port=0)
    host, port = server.server_address[:2]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    got = [None] * 12
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(i):
            got[i] = _post(f"http://{host}:{port}/predict", {"patches": patches[i].tolist()})

        clients = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
    finally:
        sys.setswitchinterval(interval)
        del model.encode_image
        server.shutdown()
        server.server_close()
        t.join(timeout=5)
    assert not t.is_alive()
    assert most[0] == 1
    assert len(threads) == 1 and threads.pop().startswith("prediction-service")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g["result"], np.float32), w)


def test_close_stops_the_worker(services):
    service = serve.PredictionService(services["tm"], services["service"].key_emb,
                                      services["service"].key_expr, top_k=4, device="cpu")
    patches = services["sections"][0].patches[:2]
    assert service.predict(patches).shape == (2, 24)
    service.close()
    with pytest.raises(RuntimeError, match="shutdown"):
        service.predict(patches)


def test_database_equals_the_eval_sweep(services):
    _, spot = embed.compute_embeddings(services["tm"], services["sections"], 32, tower="spot",
                                       device="cpu")
    np.testing.assert_array_equal(services["service"].key_emb.numpy(), spot)


def test_spot_database_is_her2st_scale_and_spot_side_only(services):
    db = synthetic.make_spot_database(24, num_sections=4, seed=5)
    assert [s.name for s in db] == ["D1", "D2", "D3", "D4"]
    assert all(300 <= s.num_spots <= 700 and s.patches is None for s in db)
    again = synthetic.make_spot_database(24, num_sections=4, seed=5)
    for a, b in zip(db, again):
        np.testing.assert_array_equal(a.eval_expression, b.eval_expression)
    service = serve.PredictionService.from_sections(services["tm"], db, top_k=8,
                                                    exclude_section=0, device="cpu")
    try:
        assert service.num_keys == sum(s.num_spots for s in db)
        assert service.n_active == service.num_keys - db[0].num_spots
        pred = service.predict(services["sections"][0].patches[:3])
        assert pred.shape == (3, 24) and np.isfinite(pred).all()
    finally:
        service.close()
