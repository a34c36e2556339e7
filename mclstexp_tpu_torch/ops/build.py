"""Build a CUDA source of ``mclstexp_tpu_torch/csrc`` into a shared library.

Each kernel source has a plain C entry point and is compiled at first use
with ``nvcc`` for ``sm_90a`` into ``<checkout>/build/kernels/`` (listed in
``.gitignore``), then loaded with ``ctypes``. The file name carries a hash
of the source, the ``csrc`` headers it includes (``#include "..."``, followed
through other headers) and the flags, so an edited source or header is
rebuilt and never confused with a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: building a CUDA kernel needs the CUDA toolkit")
    return nvcc


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(source: str) -> str:
    """A hash of ``csrc/<source>``, every header of ``csrc`` it includes
    (directly or through another header) and the nvcc flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [source]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        text = (CSRC / name).read_bytes()
        h.update(name.encode() + b"\0" + text)
        todo += sorted(m.decode() for m in _LOCAL_INCLUDE.findall(text))
    return h.hexdigest()[:12]


def build_library(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` unless an up-to-date build exists.

    Returns (library path, compiler output; empty when the build was reused).
    """
    src = CSRC / source
    digest = source_digest(source)
    lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load_library(source: str) -> ctypes.CDLL:
    path, _ = build_library(source)
    return ctypes.CDLL(str(path))
