"""Where the time of a serving request goes, at the her2st widths, on the card.

    python -m mclstexp_tpu_torch.profile_serve

Builds the her2st-width model (densenet121, 224 px, spot_dim 785,
pos_vocab 1024, 2 blocks of 8x64 heads, projection 256) with
``attn_backend="flash"`` from a seed, and a ``PredictionService`` over a
her2st-scale database (``synthetic.make_spot_database``: 32 sections of
300-700 spots, spot side only; top_k 200, weight_ord 1). Prints one JSON
object:
  * ``tower_ms_by_batch``: the image tower alone (``encode_image`` on a
    device batch), host ms per call ending in a synchronize, median of 5,
    for each power-of-two bucket from 1 to 256;
  * ``requests``: for 1, 37 and 256 patches, ``predict`` / ``embed_patches``
    / retrieval alone (``retrieve_and_aggregate`` on device query
    embeddings), host ms, median of 5;
  * ``profile``: 3 one-patch and 3 256-patch predictions under
    ``torch.profiler`` on the service's worker thread: device time in the
    "embed" and "retrieve" ranges, busy time, idle share and the top
    kernels.
Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from mclstexp_tpu_torch.config import her2st_config
from mclstexp_tpu_torch.data import synthetic
from mclstexp_tpu_torch.infer.serve import PredictionService
from mclstexp_tpu_torch.ops.build import BUILD_DIR
from mclstexp_tpu_torch.ops.retrieval import retrieve_and_aggregate
from mclstexp_tpu_torch.profile_step import summarize
from mclstexp_tpu_torch.train.state import create_train_state

REQUEST_SIZES = (1, 37, 256)
TRACE = BUILD_DIR.parent / "profile_serve_trace_{}.json"  # <checkout>/build/


def _median_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")

    cfg = her2st_config()
    model_cfg = dataclasses.replace(cfg.model, attn_backend="flash")
    model = create_train_state(model_cfg, cfg.train, "cuda").model.eval()
    db = synthetic.make_spot_database(model_cfg.spot_dim)
    service = PredictionService.from_sections(
        model, db, batch_size=cfg.eval.batch_size, top_k=cfg.eval.top_k,
        weight_ord=cfg.eval.weight_ord, max_batch=256, device="cuda")
    patch = cfg.data.patch_size
    rng = np.random.default_rng(0)

    tower = {}
    with torch.no_grad():
        for bucket in (1 << i for i in range(9)):
            x = torch.rand((bucket, patch, patch, 3), device="cuda")
            model.encode_image(x)  # the first call of a shape picks its algorithms
            tower[bucket] = _median_ms(lambda: model.encode_image(x))

    requests = {}
    for n in REQUEST_SIZES:
        patches = rng.integers(0, 256, size=(n, patch, patch, 3), dtype=np.uint8)
        service.predict(patches)
        query = torch.from_numpy(service.embed_patches(patches)).cuda()
        requests[n] = {
            "predict_ms": _median_ms(lambda: service.predict(patches)),
            "embed_patches_ms": _median_ms(lambda: service.embed_patches(patches)),
            "retrieve_ms": _median_ms(lambda: retrieve_and_aggregate(
                service.key_emb, service.key_expr, query, top_k=service.top_k,
                weight_ord=service.weight_ord, as_device=True, device="cuda")),
        }

    def profiled(patches: np.ndarray, trace: str) -> dict:
        # on the service's worker thread: its ranges are recorded there
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                service._predict(patches)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            return summarize(json.load(f), 3, phases=("embed", "retrieve"))

    TRACE.parent.mkdir(parents=True, exist_ok=True)
    profile = {}
    for n in (1, 256):
        patches = rng.integers(0, 256, size=(n, patch, patch, 3), dtype=np.uint8)
        profile[n] = service._run_on_worker(profiled, patches, str(TRACE).format(n))
    service.close()

    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "database_spots": service.num_keys,
        "tower_ms_by_batch": tower,
        "requests": requests,
        "profile": profile,
    }, indent=1))


if __name__ == "__main__":
    main()
