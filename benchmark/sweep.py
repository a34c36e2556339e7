"""The knee of a serving cell: the highest rate its service sustains.

    python3 -m benchmark.sweep --workload her2st-serve --seed 1 --seconds 20 \
        --rates 10,20,30,40,50

Builds the cell's service once, then offers its mix at each rate for
``--seconds`` (the open loop of ``drivers/open_loop.py``) and prints one
JSON line per rate: the latency's median, 95th and 99th percentiles, the
requests answered per second, and how much later than the first fifth of
the requests the last fifth waited (a backlog that grows through the run
reads high). Run once when the cell is defined; the cell's rate is then
fixed at about four fifths of the knee in its traffic file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from benchmark import harness, training
from benchmark.run import cache_dirs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.sweep")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--rates", required=True)
    args = parser.parse_args(argv)
    cache_dirs()
    cell = harness.make_cell(harness.load_json(harness.MANIFEST), args.workload, args.seed,
                             args.seconds, False)
    loop = cell.driver
    service, _, _, pool = loop.build_service(cell, harness.SetupParts(time.perf_counter()))
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(cell.traffic, rate_per_s=rate)
        requests = loop.plan(traffic, args.seed, args.seconds)
        out = loop.open_loop(service, requests, pool, args.seconds, traffic, device=cell.device)
        lat = [x * 1e3 for x in out["latency"]]
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat), "failed": len(out["failed"]),
            "answered_per_s": (len(lat) - len(out["failed"])) / out["elapsed"],
            "p50_ms": harness.percentile(lat, 50), "p95_ms": harness.percentile(lat, 95),
            "p99_ms": harness.percentile(lat, 99),
            "backlog_ms": statistics.mean(lat[-fifth:]) - statistics.mean(lat[:fifth]),
            "late_max_ms": max(out["late"]) * 1e3}), flush=True)
        training.sync(cell.device)
    service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
