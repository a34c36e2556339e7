"""The port stands alone: importing every one of its modules loads neither
JAX nor the JAX package, nor pandas, PIL or OpenCV (the card's machine has
none of them), and no module builds a kernel or needs a card when it is
imported."""

import os
import pkgutil
import subprocess
import sys

import torch

import mclstexp_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(mclstexp_tpu_torch.__path__, "mclstexp_tpu_torch.")
    )


def test_port_imports_no_jax():
    modules = _port_modules()
    assert {"mclstexp_tpu_torch.ops.row_shift", "mclstexp_tpu_torch.ops.flash_attention",
            "mclstexp_tpu_torch.ops.retrieval", "mclstexp_tpu_torch.infer.embed",
            "mclstexp_tpu_torch.infer.metrics", "mclstexp_tpu_torch.infer.evaluate",
            "mclstexp_tpu_torch.infer.serve", "mclstexp_tpu_torch.ops.patches",
            "mclstexp_tpu_torch.data.io", "mclstexp_tpu_torch.data.st_dataset",
            "mclstexp_tpu_torch.data.visium", "mclstexp_tpu_torch.data.panel",
            "mclstexp_tpu_torch.data.hvg", "mclstexp_tpu_torch.data.genes",
            "mclstexp_tpu_torch.data.posremap", "mclstexp_tpu_torch.baselines.graph",
            "mclstexp_tpu_torch.baselines.layers", "mclstexp_tpu_torch.baselines.models",
            "mclstexp_tpu_torch.baselines.trainer", "mclstexp_tpu_torch.cli.main",
            "mclstexp_tpu_torch.data.fetch", "mclstexp_tpu_torch.models.image.vit",
            "mclstexp_tpu_torch.models.image.resnet",
            "mclstexp_tpu_torch.models.image.torch_import",
            "mclstexp_tpu_torch.models.image.torch_export"} <= set(modules)
    assert len(modules) > 35
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mclstexp_tpu', 'pandas', 'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax_pandas_pil_or_cv2():
    """chip_smoke.py at import time, as the port's modules."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mclstexp_tpu', 'pandas', 'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_profile_summary_attributes_kernels_to_phases():
    """profile_step's trace summary on a hand-made two-step trace: kernels
    go to the phase whose range holds their launch, busy time is the union
    of kernel intervals, idle share the rest of the window."""
    from mclstexp_tpu_torch.profile_step import summarize

    def rng(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def launch(corr, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "args": {"correlation": corr}}

    def kernel(corr, name, ts, dur):
        return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    trace = {"traceEvents": [
        rng("augment", 0, 10), rng("forward", 10, 10), rng("backward", 20, 10),
        launch(1, 1), launch(2, 12), launch(3, 25), launch(4, 40),
        kernel(1, "void shift_rows<unsigned int>", 100, 20),
        kernel(2, "sm90_xmma_fprop_implicit_gemm", 110, 30),  # overlaps the first
        kernel(3, "ampere_sgemm_128x64_tn", 200, 40),
        kernel(4, "multi_tensor_apply_kernel", 260, 40),
    ]}
    s = summarize(trace, steps=2)
    assert s["phases"] == {"augment": 0.01, "forward": 0.015, "backward": 0.02,
                           "outside": 0.02}
    assert s["categories"] == {"matmul": 0.02, "optimizer": 0.02, "convolution": 0.015,
                               "row_shift": 0.01}
    assert s["device_busy_ms_per_step"] == (40 + 40 + 40) / 2 * 1e-3
    assert abs(s["idle_share"] - (1 - 120 / 200)) < 1e-12
    assert s["kernels_per_step"] == 2
