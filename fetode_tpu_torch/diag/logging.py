"""Structured metric logging (counterpart of
``fetode_tpu/diag/logging.py``): one JSON object per event appended to a
run file, and an optional console line."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    """Each ``log(step, **metrics)`` appends ``{"step", "wall", **metrics}``
    (``wall`` the seconds since construction, a value with ``__float__`` a
    float) to ``path``, which construction truncates, and echoes it."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            open(path, "w").close()

    def log(self, step: int, **metrics):
        rec = {"step": step, "wall": round(time.time() - self._t0, 3),
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            print(" | ".join(f"{k} {v:.6g}" if isinstance(v, float)
                             else f"{k} {v}" for k, v in rec.items()
                             if k != "wall"), flush=True)
        return rec

    def read(self):
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
