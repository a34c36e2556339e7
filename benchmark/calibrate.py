"""The readings that the output check's limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seconds <s> --seeds 1,2,3
        [--control] [--fault half_batch|unchanged|altered_answer]

Runs the cell's driver once per seed in one process and prints, per seed,
one JSON line of the numbers a check may compare: the program's (sound
runs: the lower readings), with ``--control`` those of the reference in
the configuration's lower precision (``control`` in its config file) put
in the program's place (the upper readings), or with ``--fault`` those of
the program with a planted fault (``faults.py``). The limits then go into
``checks/<cell>.json``; ``PERF.md`` keeps the readings.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark import faults, harness
from benchmark.run import cache_dirs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=[*faults.STEP_FAULTS, "altered_answer"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cache_dirs()
    manifest = harness.load_json(harness.MANIFEST)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.make_cell(manifest, args.workload, seed, args.seconds, False, args.device)
        if args.control:
            cell.control = cell.config["control"]
        planted = faults.planted(cell, args.fault) if args.fault else contextlib.nullcontext()
        t0 = time.perf_counter()
        with planted:
            out = cell.driver.run(cell, t0)
        checks = harness.judge(out["readings"], cell.checks["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed, "control": cell.control,
                          "fault": args.fault, "passes": all(c["ok"] for c in checks),
                          "readings": out["readings"], "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
