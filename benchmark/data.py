"""Inputs and weights made from the run's seed, on the device, in a few
large calls; the same tensors go to the port and to the reference.

``section_sizes`` is a frozen copy of the draw of
``mclstexp_tpu_torch/data/synthetic.make_spot_database`` (her2st's 32
sections of 300-700 spots, 15,499 in all at seed 5); ``grid`` lays a
section's spots on its square array as ``synthetic.make_section`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness import seed_int


def section_sizes(spec: dict) -> List[int]:
    """The spots of each section: ``spec`` {"count", "low", "high", "seed"}
    (numpy ``default_rng(seed).integers(low, high + 1, count)``), or
    {"grid": side} for one side x side slide."""
    if "grid" in spec:
        return [int(spec["grid"]) ** 2]
    rng = np.random.default_rng(spec["seed"])
    return [int(n) for n in rng.integers(spec["low"], spec["high"] + 1, size=spec["count"])]


def grid(n: int) -> np.ndarray:
    """(n, 2) int32 (x, y) array coordinates filling a square row by row."""
    side = int(math.ceil(math.sqrt(n)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    return np.stack([xs.ravel(), ys.ravel()], axis=1)[:n].astype(np.int32)


def generator(seed: int, *key, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_int(seed, *key))


def spots(sizes: Sequence[int], patch_size: int, genes: int, seed: int, device,
          with_patches: bool = True) -> Dict[str, torch.Tensor]:
    """Every spot of the sections ``sizes``, concatenated: uint8 (N, P, P, 3)
    patches, float32 (N, G) log-scale expression and int64 (N, 2) positions
    (``grid`` per section). The expression is log1p(exp(level)), the level
    a gene's own offset N(0, 1) plus a rank-4 factor of the spot (loadings
    shared by the genes, as ``synthetic.make_section`` draws them) plus
    noise, so that genes differ in mean and spots in profile."""
    n = int(sum(sizes))
    g = generator(seed, "spots", device=device)
    out = {"position": torch.from_numpy(np.concatenate([grid(s) for s in sizes])).long()
           .to(device)}
    offset = torch.randn((1, genes), generator=g, device=device)
    factors = torch.randn((n, 4), generator=g, device=device)
    loadings = torch.randn((4, genes), generator=g, device=device)
    noise = torch.randn((n, genes), generator=g, device=device)
    out["expression"] = torch.log1p(torch.exp(offset + 0.5 * factors @ loadings + 0.5 * noise))
    if with_patches:
        out["image_u8"] = torch.randint(0, 256, (n, patch_size, patch_size, 3),
                                        generator=g, device=device, dtype=torch.uint8)
    return out


def offsets(sizes: Sequence[int]) -> List[int]:
    return [0] + list(np.cumsum(sizes)[:-1])


def make_weights(specs: Sequence[Tuple[str, tuple, tuple]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A state dict from ``specs`` [(key, shape, init)], init one of
    ("uniform", bound), ("normal", std) (truncated at 2 std), ("const",
    value) or ("count",) (an int64 zero): two draws from the seed for all
    leaves, each leaf a scaled slice of one of them."""
    numel = {kind: sum(math.prod(shape) for _, shape, init in specs if init[0] == kind)
             for kind in ("uniform", "normal")}
    g = generator(seed, "weights", device=device)
    flat = {"uniform": torch.rand(numel["uniform"], generator=g, device=device) * 2 - 1,
            "normal": torch.randn(numel["normal"], generator=g, device=device).clamp_(-2, 2)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for key, shape, init in specs:
        kind = init[0]
        if kind in flat:
            n = math.prod(shape)
            out[key] = (flat[kind][at[kind]:at[kind] + n] * init[1]).view(shape)
            at[kind] += n
        elif kind == "const":
            out[key] = torch.full(shape, float(init[1]), device=device)
        elif kind == "count":
            out[key] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {key}")
    return out


def trainable(specs) -> List[str]:
    """The keys of ``specs`` that are parameters (not batch-norm statistics)."""
    return [key for key, _, init in specs
            if not key.endswith(("running_mean", "running_var", "num_batches_tracked"))]


def epoch_order(n: int, batch: int, seed: int, epoch: int) -> List[np.ndarray]:
    """One epoch's index batches over ``n`` rows, shuffled from the seed, the
    partial batch last (the port's loop keeps it)."""
    order = np.random.default_rng(seed_int(seed, "order", epoch)).permutation(n)
    return [order[s:s + batch] for s in range(0, n, batch)]
