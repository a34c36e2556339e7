"""Structured metric logging (JSONL), port of ``mclstexp_tpu/utils/logging.py``.

Every training run writes machine-readable step metrics; ``records`` keeps
an in-memory copy.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self.records: list = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, **metrics: Any):
        rec = {"time": time.time(), **metrics}
        self.records.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            parts = [
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            ]
            print("  ".join(parts), flush=True)

    def close(self):
        if self._f:
            self._f.close()
