"""The operation counts against torch's counter and a hand count."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness

PEAKS = harness.PEAKS


def test_densenet_forward_against_torch_counter():
    from mclstexp_tpu_torch.models.image.densenet import densenet121

    build = harness.load_module("configs", "mclstexp-her2st")
    cfg = harness.load_json(harness.ROOT / "benchmark/configs/mclstexp-her2st.json")
    with FlopCounterMode(display=False) as counter:
        densenet121("cpu")(torch.zeros(1, 224, 224, 3))
    assert build.tower_flops(cfg)[0] == counter.get_total_flops()


def test_train_step_by_hand_at_one_shape():
    build = harness.load_module("configs", "mclstexp-her2st")
    cfg = harness.load_json(harness.ROOT / "benchmark/configs/mclstexp-her2st.json")
    tower, stem = build.tower_flops(cfg)
    assert stem == 2 * 112 * 112 * 64 * 3 * 49
    b, g, p = 128, 785, 256
    spot = 2 * (2 * b * g * 1536 + 4 * b * b * 512 + 2 * b * 512 * g + 4 * b * g * g)
    heads = 2 * b * (1024 * p + p * p) + 2 * b * (g * p + p * p)
    assert build.train_flops(cfg, b) == 3 * (b * tower + spot + heads + 2 * b * b * p) - b * stem


def test_histogene_slide_by_hand():
    build = harness.load_module("configs", "histogene")
    cfg = harness.load_json(harness.ROOT / "benchmark/configs/histogene.json")
    n = 3969
    embed = 2 * n * 37632 * 1024
    layer = 2 * n * 1024 * 3072 + 4 * n * n * 1024 + 2 * n * 1024 * 1024 + 4 * n * 1024 * 2048
    assert build.slide_flops(cfg, n) == 3 * (embed + 8 * layer + 2 * n * 1024 * 785) - embed
    assert build.attention_calls(cfg, n) == (8, (1, 16, 4096, 64), n)


def test_flash_counts_by_hand():
    flash = harness.load_module("kernels", "flash")
    b, h, n, d, real = 1, 16, 4096, 64, 3969
    pairs = real * real + 127 * 127
    assert flash.forward(b, h, n, d, real) == (4 * h * pairs * d, 16 * h * n * d + 8 * h * n + 4 * n)
    assert flash.backward(b, h, n, d, real) == (10 * h * pairs * d,
                                                 28 * h * n * d + 12 * h * n + 8 * n)
    bound = flash.bound_s(b, h, n, d, real, PEAKS)
    assert bound == (14 * h * pairs * d) / PEAKS["tf32_flops_per_s"]  # compute-bound here
    assert flash.bound_s(1, 1, 128, 64, 128, PEAKS) > 0
