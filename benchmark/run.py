"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the port's kernels from build/kernels,
data and weights made on the card from the seed, the cell's own shapes
warmed, the first steps of a training cell) is timed from the process's
start as ``setup_s``; then the window runs for ``--seconds``; then the
program's outputs are compared with the plain reference. With ``--trace
1`` part of the window runs under ``torch.profiler`` and the line carries
the cell's per-layer metrics instead of its end-to-end ones. The last lines
on standard error, and the ``checks`` key that ends the result line, give
each compared number beside its limit.

Exits 2 without a result when the card is missing, 3 when a JAX module
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.trace import Traced  # noqa: E402

THREADS = 4


def cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = harness.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def run_cell(cell: harness.Cell, t_start: float) -> dict:
    """The result line of one run of ``cell`` (its ``checks`` key last)."""
    import torch

    torch.set_num_threads(THREADS)
    if cell.trace:
        Traced.warm(harness.ROOT / "build" / "benchmark" / f"{cell.name}-warm.json",
                    torch.device(cell.device).type)
    out = cell.driver.run(cell, t_start)
    checks = harness.judge(out["readings"], cell.checks["limits"])
    metrics = {}
    if not cell.trace:
        for m in cell.end_to_end:
            value = out["setup_s"] if m["name"] == "setup_s" else out["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = dict(out["layer"], config=cell.config, builder=cell.builder, peaks=harness.PEAKS)
        for m in cell.per_layer:
            value = harness.finite_or_none(harness.load_module("metrics", m["name"]).read(ctx))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.device(cell.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c["ok"] for c in checks) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if cell.trace and "busy_s" in out["layer"]:
        device["busy_s"], device["window_s"] = out["layer"]["busy_s"], out["layer"]["window_s"]
        result["breakdown"] = out["layer"]["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs()
    cell = harness.make_cell(harness.load_json(harness.MANIFEST), args.workload, args.seed,
                             args.seconds, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, T0)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: modules {bad} were loaded; the port must run without JAX",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
