"""The mixes: drawn from the seed alone, the same work for every seed, and
their parameters read from the traffic files."""

import numpy as np
import torch

from benchmark import data, harness
from benchmark.tests import tiny

MIX = harness.load_json(harness.piece("traffic", "her2st-overload", ".json"))


def loop():
    return harness.load_module("drivers", "open_loop")


def test_section_sizes_are_the_programs_draw():
    from mclstexp_tpu_torch.data import synthetic

    spec = harness.load_json(harness.piece("traffic", "her2st-fold0", ".json"))["sections"]
    sizes = data.section_sizes(spec)
    assert sizes == [s.num_spots for s in synthetic.make_spot_database(4)]
    assert sum(sizes) == 15499 and min(sizes) >= 300 and max(sizes) <= 700


def test_slide_grid_is_profile_steps():
    grid = data.grid(63 * 63)
    side = 63
    want = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2)
    np.testing.assert_array_equal(grid, want)
    assert data.section_sizes({"grid": 63}) == [3969]


def test_same_seed_same_requests_and_every_seed_the_same_work():
    a, b = loop().plan(MIX, 5, 20.0), loop().plan(MIX, 5, 20.0)
    c = loop().plan(MIX, 2**31 + 77, 20.0)
    assert a == b and a != c
    assert len(a) == len(c) == round(MIX["rate_per_s"] * 20)
    assert sorted(s for _, s, _ in a) == sorted(s for _, s, _ in c)
    gaps = lambda p: sorted(np.diff([0.0] + [t for t, _, _ in p]).round(9))  # noqa: E731
    np.testing.assert_allclose(gaps(a), gaps(c))
    block = MIX["block"]
    for start in range(0, len(a), block):
        counts = {s: sum(1 for _, x, _ in a[start:start + block] if x == s) for s, _ in MIX["sizes"]}
        assert counts == {s: round(share * block) for s, share in MIX["sizes"]}
    assert all(0 <= off <= MIX["pool"] - s for _, s, off in a)


def test_parameters_come_from_the_traffic_file():
    fast = dict(MIX, rate_per_s=2 * MIX["rate_per_s"], sizes=[[1, 1.0]], block=1)
    p = loop().plan(fast, 5, 10.0)
    assert len(p) == round(2 * MIX["rate_per_s"] * 10) and {s for _, s, _ in p} == {1}
    assert p[-1][0] < 10.0 * 1.01


def test_checked_sample_holds_every_size():
    p = loop().plan(MIX, 9, 20.0)
    ids = loop().sample(p, MIX["check_per_size"], 9)
    assert {p[i][1] for i in ids} == {s for s, _ in MIX["sizes"]}
    assert ids == loop().sample(p, MIX["check_per_size"], 9)


def test_batches_and_inputs_repeat_for_a_seed():
    assert [b.tolist() for b in data.epoch_order(100, 16, 3, 0)] == \
        [b.tolist() for b in data.epoch_order(100, 16, 3, 0)]
    batches = data.epoch_order(100, 16, 3, 1)
    assert sorted(np.concatenate(batches).tolist()) == list(range(100)) and len(batches[-1]) == 4
    x = data.spots([5, 7], 8, 4, 2**31 + 5, "cpu")
    y = data.spots([5, 7], 8, 4, 2**31 + 5, "cpu")
    for k in x:
        assert torch.equal(x[k], y[k])
    assert x["position"].max() < 64


def test_weights_repeat_and_follow_their_specs():
    ref = harness.load_module("reference", "histogene")
    cfg = dict(harness.load_json(harness.ROOT / "benchmark/configs/histogene.json"),
               **tiny.CONFIGS["histogene"])
    specs = ref.parameter_specs(cfg)
    a, b = data.make_weights(specs, 4, "cpu"), data.make_weights(specs, 4, "cpu")
    for key, shape, init in specs:
        assert a[key].shape == shape and torch.equal(a[key], b[key])
        if init[0] == "uniform":
            assert a[key].abs().max() <= init[1]
