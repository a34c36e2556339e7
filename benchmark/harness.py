"""What every cell shares: the manifest, the files found by name, seeds,
the result line and the check that no JAX module was loaded.

Nothing here imports the port: a driver does, once a cell has been chosen.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
# Top-level module names that may not be loaded in a run. Compared whole:
# the port's name, mclstexp_tpu_torch, begins with the JAX package's.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mclstexp_tpu"})
PEAKS = json.loads((BENCH / "peaks.json").read_text())


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default), each module's name cut at its first dot."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def piece(kind: str, name: str, suffix: str) -> Path:
    """``benchmark/<kind>/<name><suffix>``; raises if it is missing."""
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path.relative_to(ROOT)}")
    return path


def load_module(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded from its path (names
    may hold dots and dashes), once per process."""
    key = f"benchmark._{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, piece(kind, name, ".py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def seed_int(seed: int, *key) -> int:
    """A 63-bit seed from the run's ``seed`` and a key of non-negative ints
    or strings (``SeedSequence``), so that each use draws its own stream."""
    parts = [int(seed) % 2**64]
    for k in key:
        parts.append(int.from_bytes(k.encode(), "little") if isinstance(k, str) else int(k))
    state = np.random.SeedSequence(parts).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


@dataclasses.dataclass
class Cell:
    """One run of one cell: its manifest entry, its pieces and the run's
    options."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    # The check's control: the reference in this precision ("bf16", "tf32")
    # put in the program's place. Set only by calibrate.py.
    control: Optional[str] = None

    @property
    def builder(self):
        return load_module("configs", self.config_name)

    @property
    def reference(self):
        return load_module("reference", self.config_name)

    @property
    def driver(self):
        return load_module("drivers", self.traffic["driver"])


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def make_cell(manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda") -> Cell:
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in manifest['workloads']]}")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload, chips=int(entry["chips"]), config_name=entry["config"],
        traffic_name=entry["traffic"], config=load_json(ROOT / config["file"]),
        traffic=load_json(piece("traffic", entry["traffic"], ".json")),
        checks=load_json(piece("checks", workload, ".json")),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, workload)],
        seed=seed, seconds=seconds, trace=trace, device=device,
    )


def judge(readings: dict, limits: Dict[str, float]) -> List[dict]:
    """Each compared number beside its limit, in the limits' order. A number
    that is missing or not finite fails."""
    out = []
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        ok = math.isfinite(value) and value <= limit
        out.append({"name": name, "value": float(value), "limit": float(limit), "ok": ok})
    return out


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``."""
    ordered = sorted(values)
    return float(ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)])


class SetupParts:
    """Seconds of each part of set-up, from ``t_start`` on, for a line each
    on standard error."""

    def __init__(self, t_start: float):
        self.last, self.parts = t_start, []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.last))
        self.last = now

    def report(self) -> None:
        for name, seconds in self.parts:
            print(f"setup {name}: {seconds:.3f} s", file=sys.stderr)


def finite_or_none(value: Optional[float]) -> Optional[float]:
    return value if value is not None and math.isfinite(value) else None
