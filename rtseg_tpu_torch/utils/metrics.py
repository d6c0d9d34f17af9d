"""Segmentation metrics (counterpart of rtseg_tpu/utils/metrics.py).

`confusion_matrix` is the plain version of the confusion-matrix kernel
(ops/pallas_metrics.py): a bincount over the valid pixels. The IoU math is
host numpy in float64, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_class: int, ignore_index: int = 255
                     ) -> torch.Tensor:
    """(C, C) int32 confusion matrix with rows = true class, cols =
    predicted. A pixel counts when its label is not `ignore_index` and both
    its label and its prediction lie in [0, C)."""
    t = labels.reshape(-1).to(torch.int32).long()
    p = preds.reshape(-1).to(torch.int32).long()
    valid = ((t != ignore_index) & (t >= 0) & (t < num_class)
             & (p >= 0) & (p < num_class))
    cm = torch.bincount(t[valid] * num_class + p[valid],
                        minlength=num_class * num_class)
    return cm.reshape(num_class, num_class).to(torch.int32)


def iou_from_cm(cm) -> np.ndarray:
    """Per-class IoU (average='none' JaccardIndex semantics), float64."""
    cm = np.asarray(cm, np.float64)
    tp = np.diagonal(cm)
    union = cm.sum(axis=0) + cm.sum(axis=1) - tp
    return np.where(union > 0, tp / np.maximum(union, 1), 0.0)


def miou_from_cm(cm) -> float:
    return float(np.mean(iou_from_cm(cm)))
