"""Training metrics on disk.

Counterpart of ``moleculesde_tpu/utils/metrics.py::MetricsLogger``: the
CLIs log each printed epoch as one row of ``<output_dir>/metrics.csv``, in
the JAX package's columns and format (``step``, ``wall_time`` in seconds
since the logger was made, then the metrics in the order given).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional


class MetricsLogger:
    """Append-only CSV logger that also echoes a line to the console.  With
    no ``output_dir`` it only echoes."""

    def __init__(self, output_dir: Optional[str] = None, filename: str = "metrics.csv"):
        self.path = None
        self._fields: Optional[List[str]] = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, filename)
        self.t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], echo: Optional[str] = None) -> None:
        if echo:
            print(echo)
        if self.path is None:
            return
        row = {"step": step, "wall_time": time.time() - self.t0}
        row.update({k: float(v) for k, v in metrics.items()})
        write_header = self._fields is None
        if write_header:
            self._fields = list(row)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)
