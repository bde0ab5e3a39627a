"""Evaluation metrics and training metrics on disk.

Counterpart of ``moleculesde_tpu/utils/metrics.py``.  The ROC-AUC of the
MoleculeNet finetune over labels in {-1, 0, +1} (0: missing), per task, with
tasks that lack a positive or a negative example skipped (reference
examples/finetune_MoleculeNet.py:193-210): :func:`roc_auc_per_task` on the
host in numpy, :func:`roc_auc_mean` on the device in torch.  Both take the
rank-sum (Mann-Whitney U) form with midranks for ties, which is sklearn's
``roc_auc_score``.  The CLIs log each printed epoch as one row of
``<output_dir>/metrics.csv`` (:class:`MetricsLogger`), in the JAX package's
columns and format (``step``, ``wall_time`` in seconds since the logger
was made, then the metrics in the order given).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _midranks(s: np.ndarray) -> np.ndarray:
    """1-based ranks of ``s`` with ties given their mean rank."""
    order = np.sort(s)
    return (np.searchsorted(order, s, side="left")
            + np.searchsorted(order, s, side="right") + 1) / 2.0


def roc_auc_per_task(y_true: np.ndarray, y_scores: np.ndarray) -> List[float]:
    """The ROC-AUC of every task [M, T] that has both classes among its
    valid (non-zero) labels, in task order."""
    aucs = []
    for t in range(y_true.shape[1]):
        yt = np.asarray(y_true[:, t])
        valid = yt != 0
        pos = yt[valid] == 1
        p, n = int(pos.sum()), int((~pos).sum())
        if p == 0 or n == 0:
            continue
        ranks = _midranks(np.asarray(y_scores[valid, t], np.float64))
        aucs.append(float((ranks[pos].sum() - p * (p + 1) / 2) / (p * n)))
    return aucs


def roc_auc_mean(y_true: torch.Tensor, y_scores: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean ROC-AUC over the tasks that have both classes, number of such
    tasks) of [M, T] labels and scores, as device scalars: no host read.
    Invalid rows get +inf scores, so they sort last and change no count of
    a finite valid score; ranks are summed in float64."""
    y = y_true.T
    valid, pos, neg = y != 0, y == 1, y == -1
    s = torch.where(valid, y_scores.T.double(), float("inf")).contiguous()
    order = torch.sort(s, dim=1).values
    lt = torch.searchsorted(order, s, side="left")
    le = torch.searchsorted(order, s, side="right")
    midrank = (lt + le + 1).double() / 2.0
    p, n = pos.sum(dim=1).double(), neg.sum(dim=1).double()
    rank_sum = torch.where(pos, midrank, 0.0).sum(dim=1)
    ok = (p > 0) & (n > 0)
    auc = torch.where(ok, (rank_sum - p * (p + 1) / 2) / (p * n).clamp(min=1.0), 0.0)
    n_ok = ok.sum()
    return (auc.sum() / n_ok.clamp(min=1)).float(), n_ok


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
