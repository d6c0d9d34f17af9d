"""SegTrainer of the port: evaluation (counterpart of __init__ and
validate() of rtseg_tpu/train/trainer.py).

Training, checkpoints and prediction to files are later slices. Weights
come from Flax-shaped variables (utils/convert.py): given by the caller,
or drawn from config.random_seed.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

import numpy as np
import torch

from ..data.loader import get_val_loader
from ..models.registry import get_model
from ..utils.convert import load_jax_variables, random_jax_variables
from ..utils.metrics import iou_from_cm
from .step import build_eval_step

_INT32_MAX = np.iinfo(np.int32).max


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; it never means the CPU. The CPU is
    used only when the caller names it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('SegTrainer: no CUDA device is available; pass '
                           "device='cpu' to run on the CPU")
    return device


class SegTrainer:
    def __init__(self, config, device=None,
                 variables: Optional[Mapping] = None):
        self.device = resolve_device(device)
        config.resolve(num_devices=1)
        self.config = config
        self.logger = logging.getLogger(config.logger_name)
        self.model = get_model(config, device=self.device).eval()
        if variables is None:
            variables = random_jax_variables(self.model, config.random_seed)
        load_jax_variables(self.model, variables)
        self.val_loader = get_val_loader(
            config, pin_memory=self.device.type == 'cuda')
        self.eval_step = build_eval_step(config, self.model, self.device)
        self.cur_epoch = 0
        self.best_score = 0.0
        self.last_cm: Optional[np.ndarray] = None

    def validate(self) -> float:
        """mIoU over the val split. The confusion matrix accumulates on the
        device in int32, is flushed into a host int64 matrix before the
        pixel count could pass int32, and is read back once at the end."""
        cfg = self.config
        cm_host = np.zeros((cfg.num_class, cfg.num_class), np.int64)
        cm_dev, dev_pixels = None, 0
        for imgs, msks in self.val_loader:
            n = msks.numel()
            if n >= _INT32_MAX:
                # one batch past int32 would overflow inside the int32
                # confusion matrix itself
                raise ValueError(
                    f'Val batch has {n} pixels, >= int32 max: shrink the '
                    f'val batch (per-call bound of the on-device confusion '
                    f'matrix)')
            if cm_dev is not None and dev_pixels + n >= _INT32_MAX:
                cm_host += cm_dev.cpu().numpy().astype(np.int64)
                cm_dev, dev_pixels = None, 0
            imgs = imgs.to(self.device, non_blocking=True)
            msks = msks.to(self.device, non_blocking=True)
            part = self.eval_step(imgs, msks)
            cm_dev = part if cm_dev is None else cm_dev + part
            dev_pixels += n
        if cm_dev is None:
            raise RuntimeError('Validation loader yielded no batches.')
        cm_host += cm_dev.cpu().numpy().astype(np.int64)
        self.last_cm = cm_host
        score = float(iou_from_cm(cm_host).mean())
        self.logger.info(f'Epoch {self.cur_epoch + 1} mIoU: {score:.4f} | '
                         f'best mIoU so far: '
                         f'{max(self.best_score, score):.4f}')
        return score
