"""The output check: the references agree with the port at a small size,
a sound run is correct, and each fault a cell can have is caught."""

import math

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import tiny

CELLS = [w["name"] for w in harness.load_json(harness.MANIFEST)["workloads"]]
TRAINING = [c for c in CELLS if c != "her2st-serve"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_prints_its_line(cell, trace):
    result = tiny.run(tiny.cell(cell, trace=trace))
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["failed"] == 0 and result["attempted"] > 0
    # fp32 on both sides, on the CPU; the limits are the card's (HisToGene's
    # sit at a few 1e-6, under the CPU's own summation order at this size)
    for name, c in result["checks"].items():
        assert c["value"] < 1e-4, name
    manifest_cell = harness.make_cell(harness.load_json(harness.MANIFEST), cell, 1, 1, trace)
    wanted = manifest_cell.per_layer if trace else manifest_cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in wanted}
        assert all(m["value"] > 0 for m in result["metrics"].values())


FAULTS = [(c, f) for c in TRAINING for f in ("unchanged", "half_batch")] + \
    [("her2st-serve", "altered_answer")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_comes_out_not_correct(cell, fault):
    c = tiny.cell(cell)
    with faults.planted(c, fault):
        result = tiny.run(c)
    assert not result["correct"], result["checks"]


def test_augmentation_reference_against_the_port():
    from mclstexp_tpu_torch.ops import augment

    ref = harness.load_module("reference", "mclstexp-her2st")
    build = harness.load_module("configs", "mclstexp-her2st")
    g = torch.Generator().manual_seed(3)
    for size in (32, 224):
        u8 = torch.randint(0, 256, (6, size, size, 3), dtype=torch.uint8, generator=g)
        program_draws, ref_draws = build.draws({}, 6, g, "cpu")
        want = augment.train_augment_inline(u8, program_draws)
        got = ref.augment(u8, ref_draws)
        assert (got - want).abs().max() < 1e-5


def test_shear_reference_against_row_shift():
    from mclstexp_tpu_torch.ops.row_shift import row_shift_plain

    ref = harness.load_module("reference", "mclstexp-her2st")
    x = torch.rand(3, 16, 16, 3)
    k = torch.randint(-12, 13, (3, 16), dtype=torch.int32)
    assert torch.equal(ref.shear_rows(x, k), row_shift_plain(x, k))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell, cuda):
    """The reference in the configuration's lower precision, in the
    program's place, at the cell's own size, fails the check."""
    from benchmark.run import run_cell

    c = harness.make_cell(harness.load_json(harness.MANIFEST), cell, 2**31 + 11, 2.0, False, cuda)
    c.control = c.config["control"]
    result = run_cell(c, 0.0)
    assert not result["correct"]
    assert any(not math.isfinite(v["value"]) or v["value"] > v["limit"]
               for v in result["checks"].values())
