"""PyTorch/CUDA port of ``mclstexp_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors ``mclstexp_tpu``. The port imports neither JAX
nor the JAX package; each TPU kernel on a ported path is a hand-written
CUDA kernel under ``csrc/`` with a plain PyTorch version beside it. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
