"""SegTrainer of the port: training, validation and checkpoints
(counterpart of rtseg_tpu/train/trainer.py: __init__, load_ckpt,
save_ckpt, run, train_one_epoch, validate, val_best).

  * __init__ builds the model, its EMA copy, the optimizer (SGD, Adam or
    AdamW), the loaders and the steps, and resumes from last.ckpt when
    one exists.
  * run(): the epoch loop with begin_val_epoch / val_interval gating,
    best-score tracking, best.ckpt on improvement, last.ckpt every epoch,
    and a final val_best(). The checkpoints are written off the loop by an
    AsyncCkptWriter (train/checkpoint.py), joined before a checkpoint is
    read (load_ckpt, val_best) and at the end of run().
  * validate(): the EMA weights, as in the reference and the JAX package
    (with use_ema=False the EMA mirrors the weights exactly).

Weights come from Flax-shaped variables (utils/convert.py): given by the
caller, or drawn from config.random_seed with the initializers of Flax's
`model.init` (`flax_init_variables`). With config.backbone_ckpt a local
torchvision state_dict then replaces the backbone scope's weights
(utils/torch_import.py), before the EMA copy is made and before a
checkpoint is resumed. They seed the model and the EMA.
The dropout models (ENet, MiniNet, the smp decoders with dropout) and
MixTransformer's drop path draw their masks from the train step's
generator, seeded from config.random_seed + 1 and the step
(train/step.py), so a resumed run draws the masks of an uninterrupted one.
Under kd_training the teacher (models/registry.py get_teacher_model) is
built on the trainer's device, loaded from config.teacher_ckpt (a
checkpoint of the port, train/checkpoint.py) and frozen: eval mode, no
gradients, outside the optimizer, the EMA and the checkpoints.
With config.remat the training forward is rematerialized
(train/step.py). With config.device_norm_resolved (data.get_loader; no
ported dataset sets it yet) the steps take the loader's uint8 batches and
flip flags and normalize on the card (norm_coeffs).

Switches of the JAX trainer and loader that the port does not implement
raise NotImplementedError naming the ROADMAP.md Queue 1 item that brings
them: is_testing and spatial_partition > 1 when the trainer is built,
segpipe_cache and aug_workers > 0 in get_loader, use_tb, use_obs,
profile_dir and compile_cache in run(). Two are accepted and change no
result: recompile_guard (the JAX package's guard against a retrace of its
compiled steps; the port's steps are not traced) and device_prefetch (the
depth of the JAX package's device prefetch thread; the port copies each
batch from pinned memory with non_blocking, which overlaps the card's
work by itself).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import refuse_unported
from ..data import get_loader
from ..models.registry import get_model, get_teacher_model
from ..utils.convert import flax_init_variables, load_jax_variables
from ..utils.metrics import iou_from_cm
from ..utils.torch_import import import_backbone
from .checkpoint import (AsyncCkptWriter, load_meta, restore_train_ckpt,
                         restore_weights, snapshot_state, write_best_ckpt,
                         write_train_ckpt)
from .optim import get_optimizer
from .state import TrainState, make_ema_model
from .step import build_eval_step, build_train_step

_INT32_MAX = np.iinfo(np.int32).max

# config switches of the JAX trainer that the port does not implement yet
# (config.refuse_unported): those that change what the trainer builds,
# refused by __init__, and the planes, refused by run()
_NOT_BUILT = (('is_testing', bool, 'test-set prediction',
               'Serving engine and predict'),
              ('spatial_partition', lambda v: v > 1, 'the spatial mesh',
               'Data parallel'))
_NOT_PORTED = (('use_tb', bool, 'TensorBoard logging', 'The planes'),
               ('use_obs', bool, 'segscope telemetry', 'The planes'),
               ('profile_dir', bool, 'the profiler trace', 'The planes'),
               ('compile_cache', bool, 'the compile cache', 'The planes'))


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
        refuse_unported(config, _NOT_BUILT)
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
        self.teacher = self._load_teacher() if config.kd_training else None
        # the raw uint8 tail (get_loader resolved device_norm): the steps
        # open with the flip and normalize on the card
        norm_coeffs = (self.train_loader.norm_coeffs
                       if config.device_norm_resolved else None)
        self.train_step = build_train_step(config, norm_coeffs,
                                           teacher=self.teacher)
        self.eval_step = build_eval_step(config, self.state.ema_model,
                                         self.device, norm_coeffs)
        # checkpoint writes run off the epoch loop (save_ckpt); joined
        # before every read and at the end of run()
        self._ckpt_writer = AsyncCkptWriter()
        self.cur_epoch = 0
        self.best_score = 0.0
        self.epoch_losses = []             # mean loss per trained epoch
        self.epoch_kd_losses = []          # mean KD term per epoch (KD)
        self.last_cm: Optional[np.ndarray] = None
        self.load_ckpt()

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    @property
    def ema_model(self) -> torch.nn.Module:
        return self.state.ema_model

    def _load_teacher(self) -> torch.nn.Module:
        """The KD teacher on the trainer's device with config.teacher_ckpt's
        weights, frozen."""
        cfg = self.config
        if not cfg.teacher_ckpt or load_meta(cfg.teacher_ckpt) is None:
            raise ValueError(f'kd_training needs config.teacher_ckpt to name '
                             f'a checkpoint of the port, got '
                             f'{cfg.teacher_ckpt!r}')
        teacher = get_teacher_model(cfg, device=self.device)
        restore_weights(cfg.teacher_ckpt, teacher)
        teacher.requires_grad_(False)
        self.logger.info(f'Loaded the KD teacher {cfg.teacher_encoder}/'
                         f'{cfg.teacher_decoder} from {cfg.teacher_ckpt}')
        return teacher.eval()

    # ------------------------------------------------------------------ ckpt
    def load_ckpt(self) -> None:
        cfg = self.config
        self._ckpt_writer.join()
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
        """Queue the checkpoint's write: the loop pays for joining the
        previous write and a device-side copy of the state; the writer
        thread reads the copy back and writes it."""
        cfg = self.config
        if not cfg.save_ckpt:
            return
        # cfg.ckpt_name overrides the default name, as in the JAX package
        name = cfg.ckpt_name or ('best.ckpt' if best else 'last.ckpt')
        path = os.path.join(cfg.save_dir, name)
        self._ckpt_writer.join()
        # best.ckpt holds the EMA weights alone: copy just those
        snap = snapshot_state(self.state, weights_only=best)
        write = write_best_ckpt if best else write_train_ckpt
        epoch, score = self.cur_epoch + 1, float(self.best_score)
        self._ckpt_writer.submit(lambda: write(path, snap, epoch, score))

    # ------------------------------------------------------------------- run
    def run(self) -> float:
        cfg = self.config
        refuse_unported(cfg, _NOT_PORTED)
        start = time.perf_counter()
        try:
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
        finally:
            # the last write lands, and a failed one raises, before run()
            # returns
            self._ckpt_writer.join()

    def train_one_epoch(self) -> None:
        """One pass over the train loader. The loss is summed on the device
        and read back once, at the end of the epoch; the progress line
        every log_interval steps reads the loss of the previous log point,
        copied to the host when it was taken, so no step waits for the
        card."""
        cfg = self.config
        self.train_loader.set_epoch(self.cur_epoch)
        nb = len(self.train_loader)
        loss_sum, kd_sum, n_steps, lag = None, None, 0, None
        t_log = time.perf_counter()
        try:
            for i, batch in enumerate(self.train_loader):
                # images, masks and, from a raw-tail loader, flip flags
                batch = [t.to(self.device, non_blocking=True) for t in batch]
                self.state, metrics = self.train_step(self.state, *batch)
                loss = metrics['loss']
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if 'loss_kd' in metrics:
                    kd = metrics['loss_kd']
                    kd_sum = kd if kd_sum is None else kd_sum + kd
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
        kd_text = ''
        if kd_sum is not None:
            self.epoch_kd_losses.append(float(kd_sum) / n_steps)
            kd_text = f' | KD loss:{self.epoch_kd_losses[-1]:.4g}'
        self.logger.info(f'Epoch:{self.cur_epoch + 1}/{cfg.total_epoch} | '
                         f'Loss:{self.epoch_losses[-1]:.4g}{kd_text}')

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
        self._ckpt_writer.join()      # best.ckpt may still be in flight
        if load_meta(best_path) is not None:
            restore_weights(best_path, self.ema_model)
        return self.validate(val_best=True)
