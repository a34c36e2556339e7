"""An open loop of prediction requests into the port's
``infer/serve.py::PredictionService``.

Set-up builds the model from the seed's weights, with eval-mode batch-norm
statistics taken by the reference from a calibration batch, and the
service's database from the sections' spot side (the service embeds the
keys itself). Requests come on a schedule, whatever the service is doing:
every seed sends the same sizes and the same gaps between arrivals
(quantiles of an exponential distribution at the cell's rate), in an order
of its own (``plan``), each request a slice of a pool of patches made from
the seed.
Each request is timed from when it was due until its answer; one that
never comes within ``drain_s`` after the window counts as failed, with the
wait as its latency. A sample of the answers, drawn from the seed for each
request size, is compared with the reference's predictions.

The measure is the served rate: the spots, one a patch, of all answered
requests over the seconds from the window's start to the last answer. The
cell's rate lies above the knee, where the service never idles; the tail
there grows with the backlog through the run and is printed on standard
error, not reported.

Traffic keys: ``sections``, ``rate_per_s``, ``sizes`` ([[patches, share],
...]), ``block``, ``pool``, ``clients``, ``drain_s``, ``calibration_patches``,
``check_per_size``, ``trace_s``, ``metric``.
"""

from __future__ import annotations

import concurrent.futures as cf
import sys
import time

import numpy as np
import torch

from benchmark import data, training
from benchmark.harness import ROOT, SetupParts, percentile, seed_int
from benchmark.trace import Traced, breakdown, summarize


def plan(traffic: dict, seed: int, seconds: float):
    """(due seconds, patches, pool offset) of every request of the window.

    The window's requests come in blocks of ``block``: each block holds the
    mix's sizes in their shares exactly, and one gap between arrivals from
    each of ``block`` strata of the exponential distribution's quantiles at
    the cell's rate (Poisson gaps, the long runs of short or long gaps
    spread evenly), in an order drawn from the seed. So every seed offers
    the same load in every block."""
    rate, block = traffic["rate_per_s"], traffic["block"]
    per_block = [(size, round(share * block)) for size, share in traffic["sizes"]]
    if sum(k for _, k in per_block) != block:
        raise ValueError(f"the shares of {traffic['sizes']} do not fill a block of {block}")
    blocks = max(1, int(round(rate * seconds / block)))
    n = blocks * block
    quantiles = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng(seed_int(seed, "requests"))
    gaps = np.stack([rng.permutation(stratum) for stratum in quantiles.reshape(block, blocks)], 1)
    sizes = np.repeat([s for s, _ in per_block], [k for _, k in per_block])
    gaps = np.concatenate([rng.permutation(row) for row in gaps])
    sizes = np.concatenate([rng.permutation(sizes) for _ in range(blocks)])
    offsets = [int(rng.integers(0, traffic["pool"] - s + 1)) for s in sizes]
    return list(zip(np.cumsum(gaps).tolist(), sizes.tolist(), offsets))


def sample(requests, per_size: int, seed: int):
    """Up to ``per_size`` request indices of each size, drawn from the seed."""
    rng = np.random.default_rng(seed_int(seed, "check"))
    out = []
    for size in sorted({s for _, s, _ in requests}):
        ids = [i for i, (_, s, _) in enumerate(requests) if s == size]
        out += sorted(rng.choice(ids, min(per_size, len(ids)), replace=False).tolist())
    return out


def open_loop(service, requests, pool: np.ndarray, seconds: float, traffic: dict,
              keep=(), trace_path=None, device="cuda", on_service_thread=None) -> dict:
    """Send ``requests`` on schedule; wait up to ``drain_s`` for the answers.
    With ``trace_path``, the profiler runs on the service's device thread
    (``on_service_thread`` queues a call there) for ``trace_s`` of the
    window from its third on: that thread's ``embed`` and ``retrieve``
    ranges and every kernel of the card."""
    latency = [None] * len(requests)
    answers = {}
    keep = set(keep)
    clients = cf.ThreadPoolExecutor(max_workers=traffic["clients"], thread_name_prefix="client")
    late = []

    def call(i, due):
        _, size, off = requests[i]
        out = service.predict(pool[off:off + size])
        latency[i] = time.perf_counter() - due
        if i in keep:
            answers[i] = out

    tracer, started, stopped = None, None, None
    futures = []
    t0 = time.perf_counter()
    for i, (at, _, _) in enumerate(requests):
        if trace_path and stopped is None:
            now = time.perf_counter() - t0
            if tracer is None and now >= seconds / 3:
                tracer = Traced(trace_path, device)
                started = on_service_thread(tracer.start)
            elif tracer is not None and now >= seconds / 3 + traffic["trace_s"]:
                stopped = on_service_thread(tracer.stop)
        due = t0 + at
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - due)
        futures.append(clients.submit(call, i, due))
    if tracer is not None and stopped is None:
        stopped = on_service_thread(tracer.stop)
    done, not_done = cf.wait(futures, timeout=max(0.0, t0 + seconds - time.perf_counter())
                             + traffic["drain_s"])
    end = time.perf_counter()
    clients.shutdown(wait=False, cancel_futures=True)
    failed = [i for i, f in enumerate(futures) if f not in done or f.exception() is not None]
    for i in failed:
        latency[i] = end - (t0 + requests[i][0])
    answered = [t0 + requests[i][0] + latency[i] for i in range(len(requests)) if i not in failed]
    trace = None
    if tracer is not None:
        started.result(timeout=traffic["drain_s"])
        stopped.result(timeout=traffic["drain_s"])
        trace = tracer.collect()
    return {"latency": latency, "failed": failed, "answers": answers, "late": late,
            "served": sum(requests[i][1] for i in range(len(requests)) if i not in failed),
            "last_answer_s": (max(answered) - t0) if answered else end - t0,
            "elapsed": end - t0, "trace": trace,
            "trace_window_s": tracer.window_s if tracer is not None else None}


def build_service(cell, parts: SetupParts):
    """(service, the weights, the database's rows, the pool of patches)."""
    cfg, traffic, dev, seed = cell.config, cell.traffic, cell.device, cell.seed
    build, ref = cell.builder, cell.reference
    import mclstexp_tpu_torch.infer.serve  # noqa: F401 (the port's import, timed apart)
    parts.mark("imports")
    sizes = data.section_sizes(traffic["sections"])
    rows = data.spots(sizes, cfg["patch_size"], cfg["spot_dim"], seed, dev, with_patches=False)
    weights = build.weights(cfg, seed, dev)
    g = data.generator(seed, "patches", device=dev)
    shape = (cfg["patch_size"], cfg["patch_size"], 3)
    calibration = torch.randint(0, 256, (traffic["calibration_patches"], *shape), generator=g,
                                device=dev, dtype=torch.uint8)
    weights.update(ref.batch_stats(weights, cfg, calibration))
    del calibration
    pool = torch.randint(0, 256, (traffic["pool"], *shape), generator=g, device=dev,
                         dtype=torch.uint8).cpu().numpy()
    parts.mark("data, weights and the eval statistics (reference), the CUDA context first")
    model = build.model(cfg, weights, dev)
    sections = build.sections(rows["expression"].cpu().numpy(), rows["position"].cpu().numpy(),
                              sizes)
    service = build.service(cfg, model, sections, dev)
    training.sync(dev)
    parts.mark("model and the service's database (its spot-tower sweep)")
    for size in sorted({s for s, _ in traffic["sizes"]}):
        service.predict(pool[:size])
    training.sync(dev)
    parts.mark("one request of each size (kernels built on a first run)")
    return service, weights, rows, pool


def run(cell, t_start: float) -> dict:
    cfg, traffic, dev, seed = cell.config, cell.traffic, cell.device, cell.seed
    parts = SetupParts(t_start)
    service, weights, rows, pool = build_service(cell, parts)
    requests = plan(traffic, seed, cell.seconds)
    checked = sample(requests, traffic["check_per_size"], seed)
    setup_s = time.perf_counter() - t_start
    trace_path = ROOT / "build" / "benchmark" / f"{cell.name}-trace.json" if cell.trace else None
    out = open_loop(service, requests, pool, cell.seconds, traffic, checked, trace_path, dev,
                    lambda fn: cell.builder.on_service_thread(service, fn))
    peak = training.memory_peak(dev)
    parts.report()
    service.close()
    del service
    training.free(dev)
    late, p95_ms = out["late"], percentile(out["latency"], 95) * 1e3
    print(f"open loop: {len(requests)} requests at {traffic['rate_per_s']}/s; generator late "
          f"by {percentile(late, 50) * 1e3:.3f} ms median, {max(late) * 1e3:.3f} ms at most; "
          f"latency p95 {p95_ms:.3f} ms; {out['served']} spots served in "
          f"{out['last_answer_s']:.3f} s", file=sys.stderr)
    readings = {"pred_gap": prediction_gap(cell, weights, rows, pool, requests, out["answers"],
                                           checked)}
    layer = {}
    if out["trace"] is not None:
        summary = summarize(out["trace"], 1, ("embed", "retrieve"))
        embeds = sum(1 for e in out["trace"]["traceEvents"]
                     if e.get("cat") == "user_annotation" and e.get("name") == "embed")
        layer.update(summary=summary, busy_s=summary["busy_s"], window_s=out["trace_window_s"],
                     embed_ranges=embeds, breakdown=breakdown(out["trace"]))
    return {
        "setup_s": setup_s,
        "end_to_end": {traffic["metric"]: out["served"] / out["last_answer_s"]},
        "attempted": len(requests),
        "failed": len(out["failed"]),
        "readings": readings,
        "memory_peak_bytes": peak,
        "layer": layer,
    }


def prediction_gap(cell, weights, rows, pool, requests, answers, checked) -> float:
    """The largest relative L2 gap, over the sampled requests' rows, between
    the served predictions (the control's, where it is set) and the
    reference's; NaN if one is missing."""
    cfg, dev, ref = cell.config, cell.device, cell.reference
    keys = ref.spot_keys(weights, cfg, rows["expression"], rows["position"],
                         cfg["eval_batch_size"])
    if cell.control:
        control_keys = ref.spot_keys(weights, cfg, rows["expression"], rows["position"],
                                     cfg["eval_batch_size"], cell.control)
    worst = 0.0
    for i in checked:
        if i not in answers:
            return float("nan")
        _, size, off = requests[i]
        patches = torch.from_numpy(pool[off:off + size]).to(dev)
        want = ref.predict(weights, cfg, keys, rows["expression"], patches)
        got = torch.as_tensor(answers[i], device=dev)
        if cell.control:
            got = ref.predict(weights, cfg, control_keys, rows["expression"], patches,
                              cell.control)
        gap = (got - want).norm(dim=1) / want.norm(dim=1)
        worst = max(worst, float(gap.max()))
    return worst
