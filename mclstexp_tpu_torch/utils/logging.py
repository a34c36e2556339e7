"""Structured metric logging (JSONL), port of ``mclstexp_tpu/utils/logging.py``.

Every training run writes machine-readable step metrics; ``records`` keeps
an in-memory copy. In a process group every rank keeps the records, and
rank 0 alone writes the file and echoes (the ranks log the same values).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from mclstexp_tpu_torch.parallel import distributed


class MetricLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self.records: list = []
        self._f = None  # opened at rank 0's first record

    def log(self, **metrics: Any):
        rec = {"time": time.time(), **metrics}
        self.records.append(rec)
        if distributed.rank() != 0:
            return
        if self.path and self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a")
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
            self._f = None
