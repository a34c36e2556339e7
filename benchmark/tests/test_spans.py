"""The readers of the program's ranges (``benchmark/spans.py``) on hand-made
traces: launches counted inside and outside a range, and idle gaps split at
a range's edges."""

import pytest

from benchmark import harness, spans


def _trace(ranges, launches):
    """A Chrome trace of ``ranges`` ((name, thread, start, end)) and
    ``launches`` ((thread, launch time, kernel start, kernel end, category
    of the launching call)), in µs."""
    events = [{"cat": "user_annotation", "name": n, "tid": tid, "ts": s, "dur": e - s}
              for n, tid, s, e in ranges]
    events.append({"cat": "cpu_op", "name": "aten::add_", "tid": 1, "ts": 0, "dur": 500})
    for corr, (tid, t, ks, ke, cat) in enumerate(launches):
        events.append({"cat": cat, "name": "cudaLaunchKernel", "tid": tid, "ts": t, "dur": 3,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": f"k{corr}", "tid": 7, "ts": ks, "dur": ke - ks,
                       "args": {"correlation": corr}})
    return {"traceEvents": events}


STEPS = [("train_step", 1, 0, 100), ("train_step", 1, 200, 300), ("forward", 1, 10, 40)]
LAUNCHES = [
    (1, 10, 20, 50, "cuda_runtime"),  # inside the first step
    (2, 50, 60, 80, "cuda_runtime"),  # inside it, by another thread (autograd's)
    (1, 150, 160, 170, "cuda_runtime"),  # between the steps: the feed
    (1, 250, 260, 280, "cuda_runtime"),  # inside the second step
    (1, 260, 290, 295, "cuda_driver"),  # inside it too, by cuLaunchKernel
]


def test_launches_inside_a_range_by_their_time():
    """Four of the five launches lie inside the two steps (one by another
    thread, one by cuLaunchKernel); the feed's, between them, does not."""
    trace = _trace(STEPS, LAUNCHES)
    assert spans.launches_per_range(trace, "train_step") == 4 / 2
    assert spans.launches_per_range(trace, "forward") == 1
    ctx = {"trace": trace, "window_s": 400e-6}
    assert harness.load_module("metrics", "launches.train").read(ctx) == 4 / 2
    slide = _trace([("slide_step", 1, 0, 100)], LAUNCHES)
    assert harness.load_module("metrics", "launches.small_slide").read({"trace": slide}) == 2
    unmatched = _trace(STEPS, LAUNCHES)
    for e in unmatched["traceEvents"]:
        if e.get("cat") == "cuda_driver":
            e["args"]["correlation"] = 99  # a kernel whose launch the trace lacks: not counted
    assert spans.launches_per_range(unmatched, "train_step") == 3 / 2


def test_idle_gap_split_at_a_range_edge():
    """Kernels at 0-10 and 30-40 µs, a range over 0-20: the gap's half after
    the range is outside it."""
    trace = _trace([("slide_step", 1, 0, 20)],
                   [(1, 0, 0, 10, "cuda_runtime"), (1, 15, 30, 40, "cuda_runtime")])
    assert spans.idle_outside(trace, "slide_step", 50e-6) == pytest.approx(20.0)
    ctx = {"trace": trace, "window_s": 50e-6}
    assert harness.load_module("metrics", "idle_outside_step.small_slide").read(ctx) == \
        pytest.approx(20.0)


def test_idle_outside_the_steps_is_part_of_the_idle_share():
    """Gaps 50-60, 80-160, 170-260 and 280-290 µs against steps over 0-100
    and 200-300: 100-160 and 170-200 are outside, 90 of 400 µs."""
    trace = _trace(STEPS, LAUNCHES)
    ctx = {"trace": trace, "window_s": 400e-6}
    outside = harness.load_module("metrics", "idle_outside_step.train").read(ctx)
    assert outside == pytest.approx(22.5)
    busy = 30 + 20 + 10 + 20 + 5
    idle = harness.load_module("metrics", "idle_share.train").read(
        dict(ctx, busy_s=busy * 1e-6))
    assert outside <= idle == pytest.approx(100 * (1 - busy / 400))


@pytest.mark.parametrize("metric", ["launches.train", "launches.small_slide",
                                    "idle_outside_step.train", "idle_outside_step.small_slide"])
def test_nothing_to_read_gives_none(metric):
    """No trace (an untraced run), no range (a program that names none), no
    kernel (a run on the CPU)."""
    read = harness.load_module("metrics", metric).read
    unnamed = _trace([], LAUNCHES)
    on_cpu = _trace([("train_step", 1, 0, 100), ("slide_step", 1, 0, 100)], [])
    for ctx in ({}, {"trace": unnamed}, {"trace": on_cpu}):
        assert read(dict(ctx, window_s=1.0)) is None


def test_interval_union_and_overlap():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert spans.overlap([(0, 3), (5, 8)], [[2, 6], [7, 20]]) == 1 + 1 + 1
    assert spans.overlap([], [[0, 1]]) == 0
