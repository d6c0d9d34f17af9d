"""SegTrainer of the port: training, validation and checkpoints
(counterpart of rtseg_tpu/train/trainer.py: __init__, load_ckpt,
save_ckpt, run, train_one_epoch, validate, val_best).

  * __init__ builds the model, its EMA copy, SGD, the loaders and the
    steps, and resumes from last.ckpt when one exists.
  * run(): the epoch loop with begin_val_epoch / val_interval gating,
    best-score tracking, best.ckpt on improvement, last.ckpt every epoch,
    and a final val_best().
  * validate(): the EMA weights, as in the reference and the JAX package
    (with use_ema=False the EMA mirrors the weights exactly).

Weights come from Flax-shaped variables (utils/convert.py): given by the
caller, or drawn from config.random_seed with the initializers of Flax's
`model.init` (`flax_init_variables`). With config.backbone_ckpt a local
torchvision state_dict then replaces the backbone scope's weights
(utils/torch_import.py), before the EMA copy is made and before a
checkpoint is resumed. They seed the model and the EMA.
Prediction to files, TensorBoard, segscope telemetry, profiling and the
compile cache are later slices (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from ..data import get_loader
from ..models.registry import get_model
from ..utils.convert import flax_init_variables, load_jax_variables
from ..utils.metrics import iou_from_cm
from ..utils.torch_import import import_backbone
from .checkpoint import (load_meta, restore_train_ckpt, restore_weights,
                         save_best_ckpt, save_train_ckpt)
from .optim import get_optimizer
from .state import TrainState, make_ema_model
from .step import build_eval_step, build_train_step

_INT32_MAX = np.iinfo(np.int32).max

# config switches of the JAX trainer that the port does not implement yet,
# with the ROADMAP.md item that brings each
_NOT_PORTED = (('use_tb', 'TensorBoard logging', 'Queue 1 item 12 (obs/)'),
               ('use_obs', 'segscope telemetry', 'Queue 1 item 12 (obs/)'),
               ('profile_dir', 'the profiler trace', 'Queue 1 item 12 (obs/)'),
               ('compile_cache', 'the compile cache',
                'Queue 1 item 12 (warm/)'),
               ('remat', 'rematerialization', 'Queue 1 item 8'))


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; it never means the CPU. The CPU is
    used only when the caller names it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('SegTrainer: no CUDA device is available; pass '
                           "device='cpu' to run on the CPU")
    return device


class _HostScalar:
    """A device scalar copied to the host asynchronously; `value()` waits
    for that copy alone, not for the work queued after it."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == 'cuda':
            self.host = torch.empty((), dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def value(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.host)


class SegTrainer:
    def __init__(self, config, device=None,
                 variables: Optional[Mapping] = None):
        self.device = resolve_device(device)
        config.resolve(num_devices=1)
        self.config = config
        self.logger = logging.getLogger(config.logger_name)
        pin = self.device.type == 'cuda'
        self.train_loader, self.val_loader = get_loader(config, pin)
        model = get_model(config, device=self.device).eval()
        if variables is None:
            variables = flax_init_variables(model, config.random_seed)
        load_jax_variables(model, variables)
        if config.backbone_ckpt:
            scope = import_backbone(model, config.backbone_ckpt,
                                    config.backbone_type)
            self.logger.info(f'Imported pretrained backbone from '
                             f'{config.backbone_ckpt} into {scope}')
        self.state = TrainState(step=0, model=model,
                                optimizer=get_optimizer(config,
                                                        model.parameters()),
                                ema_model=make_ema_model(model))
        self.train_step = build_train_step(config)
        self.eval_step = build_eval_step(config, self.state.ema_model,
                                         self.device)
        self.cur_epoch = 0
        self.best_score = 0.0
        self.epoch_losses = []             # mean loss per trained epoch
        self.last_cm: Optional[np.ndarray] = None
        self.load_ckpt()

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    @property
    def ema_model(self) -> torch.nn.Module:
        return self.state.ema_model

    # ------------------------------------------------------------------ ckpt
    def load_ckpt(self) -> None:
        cfg = self.config
        path = cfg.load_ckpt_path
        meta = load_meta(path) if cfg.load_ckpt and path else None
        if meta is None:
            return
        if cfg.resume_training and meta.get('kind') == 'train':
            self.cur_epoch, self.best_score = restore_train_ckpt(path,
                                                                 self.state)
            self.logger.info(f'Resumed from {path} at epoch {self.cur_epoch}'
                             f' (best {self.best_score:.4f})')
        else:
            restore_weights(path, self.model)
            restore_weights(path, self.ema_model)
            self.logger.info(f'Loaded weights from {path}')

    def save_ckpt(self, best: bool = False) -> None:
        cfg = self.config
        if not cfg.save_ckpt:
            return
        # cfg.ckpt_name overrides the default name, as in the JAX package
        name = cfg.ckpt_name or ('best.ckpt' if best else 'last.ckpt')
        path = os.path.join(cfg.save_dir, name)
        save = save_best_ckpt if best else save_train_ckpt
        save(path, self.state, self.cur_epoch + 1, self.best_score)

    # ------------------------------------------------------------------- run
    def run(self) -> float:
        cfg = self.config
        for flag, what, item in _NOT_PORTED:
            if getattr(cfg, flag):
                raise NotImplementedError(
                    f'{flag}: {what} is not ported to PyTorch yet; set it '
                    f'off (see ROADMAP.md {item})')
        start = time.perf_counter()
        for epoch in range(self.cur_epoch, cfg.total_epoch):
            self.cur_epoch = epoch
            self.train_one_epoch()
            if (epoch >= cfg.begin_val_epoch
                    and (epoch + 1) % cfg.val_interval == 0):
                score = self.validate()
                if score > self.best_score:
                    self.best_score = score
                    self.save_ckpt(best=True)
            self.save_ckpt(best=False)
        self.logger.info(
            f'Training finished in {time.perf_counter() - start:.1f}s')
        return self.val_best()

    def train_one_epoch(self) -> None:
        """One pass over the train loader. The loss is summed on the device
        and read back once, at the end of the epoch; the progress line
        every log_interval steps reads the loss of the previous log point,
        copied to the host when it was taken, so no step waits for the
        card."""
        cfg = self.config
        self.train_loader.set_epoch(self.cur_epoch)
        nb = len(self.train_loader)
        loss_sum, n_steps, lag = None, 0, None
        t_log = time.perf_counter()
        try:
            for i, (imgs, msks) in enumerate(self.train_loader):
                imgs = imgs.to(self.device, non_blocking=True)
                msks = msks.to(self.device, non_blocking=True)
                self.state, metrics = self.train_step(self.state, imgs, msks)
                loss = metrics['loss']
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_steps += 1
                if cfg.log_interval > 0 and (i + 1) % cfg.log_interval == 0:
                    li, ll = lag if lag is not None else (i, _HostScalar(loss))
                    now = time.perf_counter()
                    ips = cfg.log_interval * cfg.train_bs / (now - t_log)
                    t_log = now
                    self.logger.info(
                        f'Epoch:{self.cur_epoch + 1}/{cfg.total_epoch} | '
                        f'Iter:{li + 1}/{nb} | Loss:{ll.value():.4g} | '
                        f'{ips:.1f} imgs/s (host clock)')
                    lag = (i, _HostScalar(loss))
        finally:
            self.model.eval()
        if loss_sum is None:
            raise RuntimeError(
                'Training loader yielded no batches; the dataset is smaller '
                'than the batch size.')
        self.epoch_losses.append(float(loss_sum) / n_steps)
        self.logger.info(f'Epoch:{self.cur_epoch + 1}/{cfg.total_epoch} | '
                         f'Loss:{self.epoch_losses[-1]:.4g}')

    def validate(self, val_best: bool = False) -> float:
        """mIoU of the EMA weights over the val split. The confusion matrix
        accumulates on the device in int32, is flushed into a host int64
        matrix before the pixel count could pass int32, and is read back
        once at the end."""
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
        if val_best:
            self.logger.info(f'Train {cfg.total_epoch} epochs finished. '
                             f'Best mIoU is: {score:.4f}')
        else:
            self.logger.info(f'Epoch {self.cur_epoch + 1} mIoU: '
                             f'{score:.4f} | best mIoU so far: '
                             f'{max(self.best_score, score):.4f}')
        return score

    def val_best(self) -> float:
        """Load best.ckpt into the EMA model and re-validate (reference
        base_trainer.py:165-186)."""
        best_path = os.path.join(self.config.save_dir, 'best.ckpt')
        if load_meta(best_path) is not None:
            restore_weights(best_path, self.ema_model)
        return self.validate(val_best=True)
