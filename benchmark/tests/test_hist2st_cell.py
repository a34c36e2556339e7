"""The ``hist2st-visium-slide`` cell on the CPU at its test size (the preset
in ``benchmark/conftest.py``), the operation count of its step, and the
reader of device time by range that its per-layer metrics use."""

import pytest

from benchmark import conftest, harness, span_time
from benchmark.tests import tiny

CELL = "hist2st-visium-slide"


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_end_to_end_and_agrees_with_the_reference(trace):
    c = tiny.cell(CELL, seed=2**31 + 5, trace=trace)
    assert c.config["patch_size"] == conftest.HIST2ST["patch_size"]
    result = tiny.run(c)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 3
    assert set(result["checks"]) == set(c.checks["limits"])
    for name, check in result["checks"].items():
        assert check["value"] < 1e-4, name
    if trace:  # a CPU trace has no kernels: the device-time readers give nothing
        assert set(result["metrics"]) == {"step_mfu.hist2st"}
    else:
        assert set(result["metrics"]) == {"slide_spots_per_s", "setup_s"}


def test_the_config_refuses_widths_the_program_does_not_build():
    c = tiny.cell(CELL)
    cfg = dict(c.config, heads=8)
    with pytest.raises(ValueError, match="heads"):
        c.builder.train_state(cfg, c.builder.weights(cfg, 1, "cpu"), "cpu")


def test_slide_step_operations_by_hand():
    build = harness.load_module("configs", "hist2st")
    cfg = harness.load_json(harness.ROOT / "benchmark/configs/hist2st.json")
    n, d, g = 3969, 1024, 785
    assert build.graph_edges(n, 4, "grid") == 4 * n  # every spot of a full grid keeps 4
    maps = n * 16 * 16
    conv = 2 * maps * 32 * (3 * 49) + 2 * (2 * maps * 32 * (2 * 25 + 32)) + 2 * maps * 32 * 4
    layer = 2 * n * d * 3072 + 4 * n * n * 1024 + 2 * n * 1024 * d + 4 * n * d * d
    graph = 4 * (2 * 4 * n * d + 2 * n * d * d)
    lstm = 4 * 2 * 2 * n * (2 * d) * (4 * d)
    forward = conv + 8 * layer + graph + lstm + 4 * 2 * n * d * g
    once = 2 * maps * 32 * 3 * 49 + 4 * 2 * 4 * n * d
    coef = 2 * n * d * d + 2 * n * d
    assert build.slide_flops(cfg, n) == 6 * (3 * forward - once) + 5 * 3 * coef
    assert 27e12 < build.slide_flops(cfg, n) < 29e12
    assert build.attention_calls(cfg, n) == (48, (1, 16, 4096, 64), n)


def _trace(ranges, kernels):
    """A Chrome trace: ``ranges`` [(name, ts, dur)], ``kernels`` [(launch
    category, launch ts, kernel dur)]."""
    events = [{"cat": "user_annotation", "name": n, "ts": t, "dur": d} for n, t, d in ranges]
    for i, (cat, t, dur) in enumerate(kernels):
        events.append({"cat": cat, "name": "launch", "ts": t, "dur": 1, "args": {"correlation": i}})
        events.append({"cat": "kernel", "name": f"k{i}", "ts": 1000 + 10 * i, "dur": dur,
                       "args": {"correlation": i}})
    return {"traceEvents": events}


def test_device_time_by_range():
    """Kernels launched (a runtime call or cuLaunchKernel) inside any range
    of the name count once, nested or repeated ranges included; the rest do
    not."""
    trace = _trace([("graph", 0, 100), ("graph", 10, 20), ("graph", 300, 50), ("jknet", 100, 50)],
                   [("cuda_runtime", 5, 1000.0), ("cuda_driver", 15, 500.0),
                    ("cuda_runtime", 320, 250.0), ("cuda_runtime", 120, 4000.0),
                    ("cuda_runtime", 200, 8000.0)])
    assert span_time.device_ms_per_step(trace, "graph", 2) == pytest.approx(0.875)
    assert span_time.device_ms_per_step(trace, "jknet", 1) == pytest.approx(4.0)
    assert span_time.device_ms_per_step(trace, "convmixer", 1) is None
    assert span_time.device_ms_per_step(_trace([("graph", 0, 10)], []), "graph", 1) is None
    assert span_time.device_ms_per_step(None, "graph", 1) is None
