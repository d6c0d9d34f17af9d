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
  * predict() (config.is_testing: __init__ builds the test folder and the
    predict weights and nothing else): colormapped PNG masks and blends
    of config.test_data_folder, through the serving engine (one CUDA
    graph an exact image shape) and pipeline.

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
(train/step.py). With config.device_norm_resolved (data.get_loader: the
raw uint8 tail of Cityscapes and Custom) the steps take the loader's
uint8 batches and flip flags and normalize on the card (norm_coeffs).

Batches reach the device as in the JAX package (`_batches`): with
config.device_prefetch > 0 a DevicePrefetcher thread keeps that many
batches in flight, copied on the card through data/segpipe/prefetch.py's
CardCopier (a ring of pinned host buffers, a side stream, the consuming
stream waiting on each copy's event); with 0 each batch is copied in the
loop, synchronously. Either way the steps see the same batches.
`epoch_stats` holds each epoch's steps, wall time and the host time the
loop spent waiting for batches (host clock).

Data parallel (parallel/mesh.py): __init__ first opens the process group
that config.multihost or a launcher's environment (torchrun) asks for, on
the process's card (cuda:LOCAL_RANK unless the caller names a device),
and resolves the config for the world size (gpu_num, the LR scaling and
the schedule, as the JAX package's mesh size does). Each rank loads its
slice of every global batch, the train step averages the gradients (and
the BatchNorm statistics under sync_bn, train/step.py), the epoch's mean
loss and the logged loss are averaged over the ranks where they are read,
validation sums the ranks' confusion matrices once, at the end, so every
rank reaches the same mIoU and best-checkpoint decision, and images/s are
logged for the global batch. Rank 0 alone logs at INFO, writes
config.json and the checkpoints; every rank reads a checkpoint only after
rank 0's writer has joined and a barrier has passed (load_ckpt, val_best,
the end of run()). Prediction runs in one process: is_testing in a world
of more than one rank raises ValueError.

Telemetry (obs/), as in the JAX trainer, for the span of run(): with
config.use_obs every rank opens its JSONL sink (save_dir/segscope/
events-<rank>.jsonl; run_start, step, epoch, memory, profile, stall,
run_end events), a StepCollector times each train and val iteration
(data wait, step, the first call of an input signature flagged compile)
and heartbeats the stall watchdog (config.watchdog, with a short
torch.profiler window on a stall under config.obs_stall_trace), and with
config.profile_every a SampledProfiler captures profile_capture_iters
train steps every profile_every steps. config.profile_dir writes a
torch.profiler trace of epoch 0's steps 1..profile_steps on rank 0, with
module ranges (obs/profile.py). With config.use_tb rank 0 writes the
train losses (one batched readback a log interval, averaged over the
ranks) and each validation's mIoU and class IoUs to TensorBoard
(utils/misc.py TBWriter). The sink, the writer and the threads open at
run() entry and close at its end, so a trainer that is built and never
run holds none of them.

With config.compile_cache (warm/), as in the JAX trainer: __init__
turns the process's compile cache on under config.compile_cache_dir
before anything builds, so the host library is loaded from it on a warm
start, and wraps the train and eval steps with warm_step over that
cache (`self._exe_cache`, one a process), so the eval step's first call
acquires K1 and K2 through it (the train step launches no kernel and
acquires nothing).
Losses and scores are those of a run without the cache.

Switches of the JAX trainer that the port does not implement raise
NotImplementedError naming the ROADMAP.md Queue 1 item that brings them:
spatial_partition > 1 when the trainer is built.
recompile_guard (the JAX package's guard against a retrace of its
compiled steps; the port's steps are not traced) is accepted and changes
nothing.
"""

from __future__ import annotations

import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import refuse_unported
from ..data import get_loader, get_test_loader
from ..data.segpipe import CardCopier, DevicePrefetcher
from ..models.registry import get_model, get_teacher_model
from ..obs import (MetricsRegistry, SampledProfiler, StallWatchdog,
                   StepCollector, emit_memory, get_sink, init_run,
                   set_registry, set_sink, span, update_memory_gauges)
from ..obs.profile import Capture, CaptureBusy, fence
from ..parallel import (all_reduce_mean, all_reduce_sum, backend, barrier,
                        init_multihost, is_distributed, local_device,
                        main_rank, process_count, process_index)
from ..utils.convert import flax_init_variables, load_jax_variables
from ..utils.metrics import iou_from_cm
from ..utils.misc import (TBWriter, get_logger, log_config, mkdir,
                          save_config, set_seed)
from ..utils.torch_import import import_backbone
from .checkpoint import (AsyncCkptWriter, load_meta, restore_train_ckpt,
                         restore_weights, snapshot_state, write_best_ckpt,
                         write_train_ckpt)
from .optim import get_optimizer
from .state import TrainState, make_ema_model
from ..warm import enable_compile_cache, warm_step
from ..warm.compile_cache import active_cache
from .step import build_eval_step, build_train_step

_INT32_MAX = np.iinfo(np.int32).max

# config switches of the JAX trainer that the port does not implement yet
# (config.refuse_unported), refused by __init__
_NOT_BUILT = (('spatial_partition', lambda v: v > 1, 'the spatial mesh',
               'Spatial mesh'),)

# module-range depth of the profile_dir trace (obs/profile.py): deep
# enough for MiT's attention (encoder/mit/block1_0/attn); a parse at any
# smaller depth reads the same trace
TRACE_DEPTH = 4


def resolve_device(device=None) -> torch.device:
    """`None` means the process's CUDA card (parallel/mesh.py
    local_device: cuda:LOCAL_RANK); it never means the CPU. The CPU is
    used only when the caller names it."""
    device = local_device(device)
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
        init_multihost(config, self.device)
        # the LR scaling and the schedule follow the world size
        config.resolve(num_devices=process_count())
        self.config = config
        if config.compile_cache:
            # every library build of the process through the cache, before
            # anything builds (the loaders' host library included)
            enable_compile_cache(config)
        self.main_rank = main_rank()
        self.logger = get_logger(config, main_rank=self.main_rank)
        if is_distributed():
            self.logger.info(f'Data parallel: {process_count()} rank(s) '
                             f'over {backend()}, rank {process_index()} on '
                             f'{self.device}')
        mkdir(config.save_dir)
        set_seed(config.random_seed)
        # the live metrics registry: prediction's pipeline and the step
        # collectors feed it
        self.metrics = MetricsRegistry()
        set_registry(self.metrics)
        # run() scope: the JSONL sink, the stall watchdog, the sampled
        # profiler and the TensorBoard writer
        self._obs_sink = None
        self._watchdog = None
        self._profiler = None
        self.writer = None
        self._tb_live = False
        if config.is_testing:
            if process_count() > 1:
                raise ValueError(
                    f'prediction (is_testing) runs in one process; this '
                    f'one is rank {process_index()} of {process_count()}: '
                    f'run it without a launcher')
            self.test_set = get_test_loader(config)
            self._init_state_for_predict()
            return
        self.train_loader, self.val_loader = get_loader(config)
        # the card's copies of the batches (None on the CPU)
        self._copier = (CardCopier(self.device, slots=config.device_prefetch
                                   + 1)
                        if self.device.type == 'cuda' else None)
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
        self._exe_cache = None
        if config.compile_cache:
            # each step's first call acquires the kernel libraries it
            # launches through the process's cache (warm/prime.py)
            self._exe_cache = active_cache()
            self.train_step = warm_step(self.train_step, self._exe_cache,
                                        'train_step')
            self.eval_step = warm_step(self.eval_step, self._exe_cache,
                                       'eval_step')
        # checkpoint writes run off the epoch loop (save_ckpt); joined
        # before every read and at the end of run()
        self._ckpt_writer = AsyncCkptWriter()
        self.cur_epoch = 0
        self.best_score = 0.0
        self.epoch_losses = []             # mean loss per trained epoch
        self.epoch_kd_losses = []          # mean KD term per epoch (KD)
        self.epoch_stats = []              # steps, wall_s, data_wait_s
        self.val_history = []              # (epoch, mIoU) of run()'s vals
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
    def _settled(self) -> None:
        """Rank 0's checkpoint writes on disk before any rank reads:
        its writer joined, then a barrier (no collective without a
        group)."""
        self._ckpt_writer.join()
        barrier()

    def load_ckpt(self) -> None:
        cfg = self.config
        self._settled()
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
        if not cfg.save_ckpt or not self.main_rank:
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
    def _put(self, batch) -> tuple:
        """A host batch on its way to the device; on the card this runs on
        the prefetch thread and returns what `_take` finishes. A
        ``data/h2d`` span times it (the report's h2d row)."""
        with span('data/h2d'):
            return batch if self._copier is None else self._copier(batch)

    def _take(self, item) -> tuple:
        return item if self._copier is None else self._copier.ready(item)

    def _batches(self, loader):
        """The loader's batches on the device, in order: through the
        prefetch thread (config.device_prefetch deep) or copied one by one
        in the loop when it is 0."""
        if self.config.device_prefetch <= 0:
            for batch in loader:
                with span('data/h2d'):
                    batch = tuple(t.to(self.device) for t in batch)
                yield batch
            return
        prefetcher = DevicePrefetcher(loader, self._put,
                                      depth=self.config.device_prefetch)
        try:
            for item in prefetcher:
                yield self._take(item)
        finally:
            # stops the thread and, through it, the loader's producer and
            # its workers, also when a step raises
            prefetcher.close()

    def _open_planes(self) -> None:
        """The TensorBoard writer, the JSONL sink (every rank), the stall
        watchdog and the sampled profiler, as config asks."""
        cfg = self.config
        self.writer = TBWriter(cfg, self.main_rank)
        # whether any rank writes TB scalars: rank 0 alone does, and every
        # rank must take the same path through _flush_tb's all-reduce
        self._tb_live = cfg.use_tb and bool(all_reduce_sum(torch.tensor(
            [float(self.writer.active)], device=self.device)).item())
        if not cfg.use_obs:
            return
        self._obs_sink = init_run(cfg.obs_dir, meta={
            'model': cfg.model, 'dataset': cfg.dataset,
            'total_epoch': cfg.total_epoch,
            'global_train_bs': cfg.train_bs * cfg.gpu_num,
            'global_val_bs': cfg.val_bs * cfg.gpu_num,
            'compute_dtype': cfg.compute_dtype,
            'devices': cfg.gpu_num})
        set_sink(self._obs_sink)
        if cfg.watchdog:
            self._watchdog = StallWatchdog(
                self._obs_sink, min_deadline_s=cfg.watchdog_min_s,
                factor=cfg.watchdog_factor,
                trace_dir=(os.path.join(cfg.obs_dir, 'stall_trace')
                           if cfg.obs_stall_trace else None),
                logger=self.logger)
            self._watchdog.start()
        if cfg.profile_every > 0:
            # every profile_every train steps capture
            # profile_capture_iters fenced iterations and emit the parsed
            # device-time breakdown as a 'profile' event
            self._profiler = SampledProfiler(
                self._obs_sink, every=cfg.profile_every,
                iters=cfg.profile_capture_iters, jitted=self.train_step,
                registry=self.metrics, logger=self.logger,
                models=(self.model,))

    def _close_planes(self, start: float) -> None:
        """Tear down what _open_planes opened; run_end carries run()'s
        wall (the goodput denominator: trainer construction excluded)."""
        if self._profiler is not None:
            # a step that raised mid-capture leaves a window half-open
            self._profiler.abort()
            self._profiler = None
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._obs_sink is not None:
            self._obs_sink.emit({
                'event': 'run_end',
                'wall_s': round(time.perf_counter() - start, 3)})
            self._obs_sink.close()
            if get_sink() is self._obs_sink:
                set_sink(None)
            self._obs_sink = None
        if self.writer is not None:
            self.writer.close()
            self.writer = None
            self._tb_live = False

    def run(self) -> float:
        cfg = self.config
        if self.main_rank:
            save_config(cfg)
            log_config(cfg, self.logger)
        start = time.perf_counter()
        try:
            self._open_planes()
            for epoch in range(self.cur_epoch, cfg.total_epoch):
                self.cur_epoch = epoch
                self.train_one_epoch()
                if (epoch >= cfg.begin_val_epoch
                        and (epoch + 1) % cfg.val_interval == 0):
                    score = self.validate()
                    self.val_history.append((epoch + 1, score))
                    if score > self.best_score:
                        self.best_score = score
                        self.save_ckpt(best=True)
                self.save_ckpt(best=False)
            self.logger.info(
                f'Training finished in {time.perf_counter() - start:.1f}s')
            score = self.val_best()
        finally:
            # the last write lands, and a failed one raises, before run()
            # returns; a failed write does not skip the planes' teardown
            try:
                self._ckpt_writer.join()
            finally:
                self._close_planes(start)
        # no rank returns before rank 0's checkpoints are on disk
        barrier()
        return score

    def train_one_epoch(self) -> None:
        """One pass over the train loader. The loss is summed on the device
        and read back once, at the end of the epoch; the progress line
        every log_interval steps reads the loss of the previous log point,
        copied to the host when it was taken, so no step waits for the
        card. In a process group both are averaged over the ranks (once
        an epoch and once a log point), and images/s count the global
        batch. The StepCollector times each iteration on the host (no
        device read), the sampled profiler and the profile_dir trace open
        and close their windows around the steps, and the TensorBoard
        losses are read back in one batch a log interval."""
        cfg = self.config
        self.train_loader.set_epoch(self.cur_epoch)
        nb = len(self.train_loader)
        loss_sum, kd_sum, n_steps, lag = None, None, 0, None
        t_start = time.perf_counter()
        col = StepCollector(self._obs_sink, 'train',
                            imgs_per_step=cfg.train_bs * cfg.gpu_num,
                            jitted=self.train_step, watchdog=self._watchdog,
                            epoch=self.cur_epoch, registry=self.metrics)
        # event and TB step ids from the host's step count
        step0 = self.state.step
        tb_buf = []
        tb_every = cfg.log_interval if cfg.log_interval > 0 else 50
        # the profile_dir trace of epoch 0 (rank 0) owns the profiler;
        # the sampled captures stand down meanwhile, on every rank
        tracing = cfg.profile_dir is not None and self.cur_epoch == 0
        sampler = None if tracing else self._profiler
        trace, completed = None, False
        batches = self._batches(self.train_loader)
        try:
            # images, masks and, from a raw-tail loader, flip flags
            for i, batch in enumerate(col.wrap(batches)):
                if tracing and self.main_rank and i == 1:
                    trace = self._start_trace()  # after the first call
                if sampler is not None:
                    sampler.before_step()
                with span('train/dispatch', record=False):
                    self.state, metrics = self.train_step(self.state,
                                                          *batch)
                loss = metrics['loss']
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if 'loss_kd' in metrics:
                    kd = metrics['loss_kd']
                    kd_sum = kd if kd_sum is None else kd_sum + kd
                n_steps += 1
                col.end_step(step=step0 + n_steps)
                if sampler is not None:
                    sampler.after_step(step=step0 + n_steps)
                if trace is not None and i == cfg.profile_steps:
                    self._stop_trace(trace)
                    trace = None
                if cfg.log_interval > 0 and (i + 1) % cfg.log_interval == 0:
                    mean = _HostScalar(all_reduce_mean(loss))
                    li, ll = lag if lag is not None else (i, mean)
                    ips, dwf = col.interval_stats()
                    self.logger.info(
                        f'Epoch:{self.cur_epoch + 1}/{cfg.total_epoch} | '
                        f'Iter:{li + 1}/{nb} | Loss:{ll.value():.4g} | '
                        f'{ips:.1f} imgs/s | data-wait {dwf:.0%} (host '
                        f'clock)')
                    lag = (i, mean)
                if self._tb_live:
                    tb_buf.append((step0 + n_steps, metrics))
                    if len(tb_buf) >= tb_every:
                        self._flush_tb(tb_buf)
            completed = True
        finally:
            batches.close()
            self.model.eval()
            if trace is not None:
                # an epoch shorter than the window writes what it traced;
                # a step that raised drops it
                if completed:
                    self._stop_trace(trace)
                else:
                    trace.abort()
        if sampler is not None:
            # a window opened on the epoch's last steps must not stay open
            # across validation and checkpointing
            sampler.finish(step=step0 + n_steps)
        if loss_sum is None:
            raise RuntimeError(
                'Training loader yielded no batches; the dataset is smaller '
                'than the batch size.')
        self._flush_tb(tb_buf)
        self.epoch_losses.append(float(all_reduce_mean(loss_sum)) / n_steps)
        # the read of the loss waited for the epoch's last step
        self.epoch_stats.append({'steps': n_steps,
                                 'data_wait_s': col.total_wait,
                                 'wall_s': time.perf_counter() - t_start})
        kd_text = ''
        if kd_sum is not None:
            self.epoch_kd_losses.append(float(all_reduce_mean(kd_sum))
                                        / n_steps)
            kd_text = f' | KD loss:{self.epoch_kd_losses[-1]:.4g}'
        self.logger.info(f'Epoch:{self.cur_epoch + 1}/{cfg.total_epoch} | '
                         f'Loss:{self.epoch_losses[-1]:.4g}{kd_text}')
        if self._obs_sink is not None:
            self._obs_sink.emit({
                'event': 'epoch', 'epoch': self.cur_epoch, 'kind': 'train',
                'steps': n_steps, 'mean_loss': self.epoch_losses[-1],
                'data_wait_s': round(col.total_wait, 3),
                'step_s': round(col.total_dur, 3),
                'compile_s': round(col.compile_s, 3)})
            emit_memory(self._obs_sink)
        # the card's memory watermarks onto the live plane (nothing
        # without CUDA)
        update_memory_gauges(self.metrics)

    def _start_trace(self) -> Optional[Capture]:
        """Open the profile_dir trace (module ranges on the model), or
        None with a warning when another capture holds the profiler."""
        fence()
        try:
            return Capture((self.model,), TRACE_DEPTH)
        except CaptureBusy as e:
            self.logger.warning(f'profile_dir: no trace written ({e})')
            return None

    def _stop_trace(self, trace: Capture) -> None:
        fence()
        path = trace.stop(self.config.profile_dir)
        self.logger.info(f'Profiler trace in {path}')

    _TB_KEYS = (('loss', 'train/loss'), ('loss_detail', 'train/loss_detail'),
                ('loss_kd', 'train/loss_kd'))

    def _flush_tb(self, buf) -> None:
        """Write buffered (step, metrics) pairs to TensorBoard with ONE
        batched device-to-host readback for the interval (averaged over
        the ranks in a process group, on every rank, so the collective
        matches)."""
        if not buf:
            return
        keys = [[k for k, _ in self._TB_KEYS if k in m] for _, m in buf]
        flat = torch.stack([m[k].detach().float().reshape(())
                            for (_, m), ks in zip(buf, keys) for k in ks])
        vals = iter(all_reduce_mean(flat).cpu().tolist())
        tags = dict(self._TB_KEYS)
        for (step_id, m), ks in zip(buf, keys):
            scalars = {tags[k]: next(vals) for k in ks}
            if 'loss_kd' in m:
                scalars['train/loss_total'] = scalars['train/loss']
            self.writer.add_scalars(scalars, step_id)
        buf.clear()

    def validate(self, val_best: bool = False) -> float:
        """mIoU of the EMA weights over the val split. The confusion matrix
        accumulates on the device in int32, is flushed into a host int64
        matrix before the pixel count could pass int32, and is read back
        once at the end; in a process group each rank counts its slice and
        the int64 matrices are summed over the ranks then, once."""
        cfg = self.config
        cm_host = np.zeros((cfg.num_class, cfg.num_class), np.int64)
        cm_dev, dev_pixels = None, 0
        col = StepCollector(self._obs_sink, 'val',
                            imgs_per_step=cfg.val_bs * cfg.gpu_num,
                            jitted=self.eval_step, watchdog=self._watchdog,
                            epoch=self.cur_epoch, registry=self.metrics)
        batches = self._batches(self.val_loader)
        try:
            for imgs, msks in col.wrap(batches):
                n = msks.numel()
                if n >= _INT32_MAX:
                    # one batch past int32 would overflow inside the int32
                    # confusion matrix itself
                    raise ValueError(
                        f'Val batch has {n} pixels, >= int32 max: shrink '
                        f'the val batch (per-call bound of the on-device '
                        f'confusion matrix)')
                if cm_dev is not None and dev_pixels + n >= _INT32_MAX:
                    cm_host += cm_dev.cpu().numpy().astype(np.int64)
                    cm_dev, dev_pixels = None, 0
                with span('val/dispatch', record=False):
                    part = self.eval_step(imgs, msks)
                cm_dev = part if cm_dev is None else cm_dev + part
                dev_pixels += n
                col.end_step()
        finally:
            batches.close()
        if cm_dev is None:
            raise RuntimeError('Validation loader yielded no batches.')
        with span('val/readback'):
            cm_host += cm_dev.cpu().numpy().astype(np.int64)
        if is_distributed():
            cm_host = all_reduce_sum(torch.from_numpy(cm_host).to(
                self.device)).cpu().numpy()
        self.last_cm = cm_host
        iou = iou_from_cm(cm_host)
        score = float(iou.mean())
        if val_best:
            self.logger.info(f'Train {cfg.total_epoch} epochs finished. '
                             f'Best mIoU is: {score:.4f}')
        else:
            self.logger.info(f'Epoch {self.cur_epoch + 1} mIoU: '
                             f'{score:.4f} | best mIoU so far: '
                             f'{max(self.best_score, score):.4f}')
            if self.writer is not None:
                scalars = {'val/mIoU': score}
                scalars.update({f'val/IoU_cls{i:02d}': iou[i]
                                for i in range(cfg.num_class)})
                self.writer.add_scalars(scalars, self.cur_epoch + 1)
        if self._obs_sink is not None:
            self._obs_sink.emit({
                'event': 'epoch', 'epoch': self.cur_epoch, 'kind': 'val',
                'steps': col.n_steps, 'miou': score,
                'data_wait_s': round(col.total_wait, 3),
                'step_s': round(col.total_dur, 3)})
        return score

    def val_best(self) -> float:
        """Load best.ckpt into the EMA model and re-validate (reference
        base_trainer.py:165-186)."""
        best_path = os.path.join(self.config.save_dir, 'best.ckpt')
        self._settled()               # best.ckpt may still be in flight
        if load_meta(best_path) is not None:
            restore_weights(best_path, self.ema_model)
        return self.validate(val_best=True)

    # --------------------------------------------------------------- predict
    def _init_state_for_predict(self) -> None:
        """The predict model: Flax's initializers (seed 0, as the JAX
        trainer's PRNGKey(0) init), then config.load_ckpt_path's weights;
        a path without a checkpoint raises rather than predicting with
        random weights."""
        cfg = self.config
        model = get_model(cfg, device=self.device).eval()
        load_jax_variables(model, flax_init_variables(model, 0))
        if cfg.load_ckpt and cfg.load_ckpt_path:
            if load_meta(cfg.load_ckpt_path) is None:
                raise FileNotFoundError(
                    f'Could not find any pretrained checkpoint at '
                    f'{cfg.load_ckpt_path}.')
            restore_weights(cfg.load_ckpt_path, model)
            self.logger.info(f'Loaded weights from {cfg.load_ckpt_path}')
        self.predict_model = model

    def predict(self) -> None:
        """Reference core/seg_trainer.py:154-191: argmax -> colormap LUT ->
        RGB PNG mask and/or alpha-blend overlay, under save_dir/predicts
        and save_dir/predicts_blend.

        The images go through the serving engine and pipeline
        (rtseg_tpu_torch/serve/), bucketed by their exact post-transform
        shape, read from the image headers alone: one CUDA graph a shape at
        batch test_bs, batches padded in the batch dimension only, which
        leaves each mask what a one-image batch gives. A sliding window
        keeps at most max(2 * batch, 8) images resident and writes the
        outputs in index order. The blend resizes the mask to the raw
        image with PIL's NEAREST (data/transforms.py resize_nearest_pil)
        and truncates the float32 blend to uint8, as the JAX package."""
        from collections import deque
        from ..data import png
        from ..data.transforms import resize_nearest_pil
        from ..export import build_inference_fn
        from ..serve import ServeEngine, ServePipeline
        from ..utils.colormap import get_colormap
        cfg = self.config
        colormap = get_colormap(cfg)
        save_dir = os.path.join(cfg.save_dir, 'predicts')
        blend_dir = os.path.join(cfg.save_dir, 'predicts_blend')
        mkdir(save_dir)
        if cfg.blend_prediction:
            mkdir(blend_dir)
        n = len(self.test_set)
        if n == 0:
            self.logger.info(f'No test images; nothing saved to {save_dir}')
            return
        shapes = sorted({self.test_set.shape(i) for i in range(n)})
        batch = max(1, min(cfg.test_bs, n))
        engine = ServeEngine(build_inference_fn(self.predict_model,
                                                cfg.compute_dtype),
                             shapes, batch, device=self.device,
                             name='predict_engine')

        def save(path, array):
            with open(path, 'wb') as f:
                f.write(png.encode(array))

        def write(raw, name, res):
            mask_rgb = colormap[res.mask]
            base = os.path.splitext(name)[0]
            if cfg.save_mask:
                save(os.path.join(save_dir, f'{base}.png'), mask_rgb)
            if cfg.blend_prediction:
                h, w = raw.shape[:2]
                up = resize_nearest_pil(mask_rgb, w, h)
                blend = (raw.astype(np.float32) * (1 - cfg.blend_alpha)
                         + up.astype(np.float32) * cfg.blend_alpha)
                save(os.path.join(blend_dir, f'{base}.png'),
                     blend.astype(np.uint8))

        window = max(2 * batch, 8)
        pending = deque()                 # (raw, name, future)
        with ServePipeline(engine, max_wait_ms=1.0,
                           max_queue=window + batch,
                           registry=self.metrics) as pipe:
            for i in range(n):
                if len(pending) >= window:
                    raw0, name0, fut = pending.popleft()
                    write(raw0, name0, fut.result())
                raw, aug, name = self.test_set.get(i)
                pending.append((raw, name, pipe.submit(aug)))
            while pending:
                raw0, name0, fut = pending.popleft()
                write(raw0, name0, fut.result())
        self.predict_stats = engine.stats()
        self.logger.info(
            f'Predictions saved to {save_dir} ({len(shapes)} shape '
            f'bucket(s), {self.predict_stats["cuda_graphs"]} CUDA graphs, '
            f'batch {batch})')
