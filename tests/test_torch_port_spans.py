"""The port's ``torch.profiler`` ranges and the service's counters, on the CPU.

The flagship step is a ``train_step`` range around its ``augment`` /
``forward`` / ``backward`` / ``optimizer`` phases; the slide step a
``slide_step`` range around ``forward`` / ``backward`` / ``optimizer``;
each prediction of ``PredictionService`` a ``predict`` range around
``embed`` and ``retrieve`` on the service's worker thread. The service
counts requests, rows, bucket padding, queue wait and worker seconds.
"""

import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mclstexp_tpu_torch.baselines import models, trainer
from mclstexp_tpu_torch.config import ModelConfig
from mclstexp_tpu_torch.data import pipeline, synthetic
from mclstexp_tpu_torch.infer import serve
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.train.state import TrainState, torch_adam
from mclstexp_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

TINY = dict(encoder_name="tiny_densenet", image_dim=16, spot_dim=24, projection_dim=32,
            heads_num=2, heads_dim=16, head_layers=1, pos_vocab=64, dense_block_impl="concat")
STATS = {"requests", "rows", "padded_rows", "queue_wait_s", "worker_s"}


def _ranges(prof, names):
    """(name, parent's name) of the profiled ranges named in ``names``, in
    the order they started."""
    events = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None) for e in events]


def test_train_step_range_holds_its_four_phases():
    sections = synthetic.make_dataset(num_sections=2, num_spots=8, num_genes=24, patch_size=16,
                                      seed=1)
    data = pipeline.ConcatSections.from_sections(sections)
    model = MclSTExp(ModelConfig(**TINY), device="cpu")
    state = TrainState(model, torch_adam(model.parameters(), 1e-3, 0.0))
    batch = {k: torch.from_numpy(v) for k, v in data.take(np.arange(8)).items()}
    draws = augment.sample_st_draws(torch.Generator().manual_seed(0), 8, "cpu")
    step = make_train_step("st")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, draws)
    phases = ("augment", "forward", "backward", "optimizer")
    assert _ranges(prof, ("train_step", *phases)) == \
        [("train_step", None)] + [(p, "train_step") for p in phases]


def test_slide_step_range_holds_forward_backward_optimizer():
    cfg = trainer.BaselineConfig(model="histogene", n_genes=8, patch_size=16, bucket=16)
    model = models.HisToGene(8, 16, dim=32, n_layers=1, heads=2, device="cpu")
    state = TrainState(model, torch_adam(model.parameters(), 1e-3, 0.0))
    section = synthetic.make_section("S0", 13, 8, 16, seed=0)
    batch = trainer.slide_tensors(trainer.pad_slide(section, 16, False, cfg), "cpu")
    step = trainer.make_slide_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = step(state, batch, torch.Generator().manual_seed(0))
    phases = ("forward", "backward", "optimizer")
    assert _ranges(prof, ("slide_step", *phases)) == \
        [("slide_step", None)] + [(p, "slide_step") for p in phases]
    assert state.step == 1 and torch.isfinite(loss)


@pytest.fixture(scope="module")
def service():
    sections = synthetic.make_dataset(num_sections=2, num_spots=20, num_genes=24, patch_size=16,
                                      seed=3)
    model = MclSTExp(ModelConfig(**TINY), device="cpu")
    s = serve.PredictionService.from_sections(model, sections, batch_size=32, top_k=8,
                                              max_batch=256, device="cpu")
    yield s, sections[0].patches
    s.close()


def test_predict_range_holds_embed_and_retrieve_on_the_worker(service):
    s, patches = service
    prof = profile(activities=[ProfilerActivity.CPU])
    s._worker.submit(prof.start).result()  # the profiler sees the thread that starts it
    s.predict(patches[:3])
    s._worker.submit(prof.stop).result()
    assert _ranges(prof, ("predict", "embed", "retrieve")) == \
        [("predict", None), ("embed", "predict"), ("retrieve", "predict")]
    assert {e.thread for e in prof.events() if e.name == "predict"} == \
        {e.thread for e in prof.events() if e.name == "embed"}


def test_stats_count_requests_rows_and_bucket_padding(service):
    """1, 37 and 256 patches at max_batch 256: buckets of 1, 64 and 256."""
    s, patches = service
    before = s.stats()
    assert set(before) == STATS
    for n in (1, 37, 256):
        s.predict(np.resize(patches, (n, *patches.shape[1:])))
    after = s.stats()
    diff = {k: after[k] - before[k] for k in STATS}
    assert (diff["requests"], diff["rows"], diff["padded_rows"]) == (3, 294, 27)
    assert diff["queue_wait_s"] >= 0 and diff["worker_s"] > 0
    s.embed_patches(patches[:3])  # an embedding is not a prediction
    assert s.stats()["requests"] == after["requests"]


def test_stats_snapshots_stay_whole_under_concurrent_clients(service):
    """Eight client threads (more than the cores) send 3-patch requests
    while another reads ``stats()`` with a short thread switch interval:
    every snapshot holds 3 rows and 1 padded row per request, and none is
    lost."""
    s, patches = service
    before = s.stats()
    read, torn, stop = [0], [], threading.Event()

    def whole(snap):
        n = snap["requests"] - before["requests"]
        return snap["rows"] - before["rows"] == 3 * n and \
            snap["padded_rows"] - before["padded_rows"] == n

    def reader():
        while not stop.is_set():
            snap = s.stats()
            read[0] += 1
            if not whole(snap):
                torn.append(snap)

    def client():
        for _ in range(3):
            s.predict(patches[:3])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    watcher = threading.Thread(target=reader)
    clients = [threading.Thread(target=client) for _ in range(8)]
    try:
        watcher.start()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
    finally:
        stop.set()
        watcher.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not watcher.is_alive() and not any(c.is_alive() for c in clients)
    assert read[0] > 0 and torn == [] and whole(s.stats())
    assert s.stats()["requests"] - before["requests"] == 24


@pytest.mark.parametrize("max_batch", [1, 7, 32, 200, 256])
def test_padded_rows_are_the_padding_of_the_tower_chunks(max_batch):
    for n in range(1, 600):
        chunks = [min(max_batch, n - start) for start in range(0, n, max_batch)]
        want = sum(serve._bucket_size(b, max_batch) - b for b in chunks)
        assert serve._padded_rows(n, max_batch) == want, n


def test_info_carries_the_stats_over_http(service):
    s, patches = service
    s.predict(patches[:5])
    server = serve.make_server(s, port=0)
    host, port = server.server_address[:2]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/info", timeout=30) as r:
            info = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=5)
    assert not t.is_alive()
    assert info["stats"] == s.stats() and info["stats"]["requests"] >= 1
