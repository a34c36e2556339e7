"""The benchmark of the PyTorch/CUDA port (``mclstexp_tpu_torch``) on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells. Every piece of a
cell is a file found by its name: ``configs/<config>.json`` (the sizes as
run) with ``configs/<config>.py`` (builds the port's objects from them),
``reference/<config>.py`` (the plain reference), ``traffic/<mix>.json``
(the mix's parameters, read by ``drivers/<driver>.py``),
``checks/<cell>.json`` (the limits of the output check),
``metrics/<metric>.py`` (one per-layer metric's reader) and
``kernels/<kernel>.py`` (a kernel's operations and bytes).
"""
