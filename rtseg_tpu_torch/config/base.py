"""Typed configuration for the PyTorch/CUDA port (stdlib only).

A copy of rtseg_tpu/config/base.py, kept field for field so configs stay
interchangeable between the two packages; the port does not import the JAX
package. Two fields change meaning: `fused_head` and `use_pallas_metrics`
resolve their `None` (auto) to "CUDA kernel on a CUDA device, plain PyTorch
version on the CPU". The TPU-only layout levers (`pack_fullres`,
`s2d_stem`, `detail_remat`, `hires_remat`) stay as fields; the port's
BiSeNetv2 refuses them, and DDRNet and STDC refuse `hires_remat`
(`s2d_stem` is an exact rewrite of the stem conv in the JAX package: the
other models compute the same without it).

Mirrors the capability surface of the reference's flat config object
(reference: configs/base_config.py:2-109) but as an explicit dataclass with a
single derived-field resolution step (`resolve`) instead of scattered runtime
mutation of a god-object (see reference core/base_trainer.py:20,
utils/parallel.py:22-29, utils/scheduler.py:7-10).

Naming bugs of the reference are intentionally fixed here:
  - `dataroot` vs `data_root` (base_config.py:5 vs cityscapes.py:104) -> `data_root`
  - `logger_name`, `train_size`, `test_size`, `reduction` used-but-undefined
    (utils/utils.py:33, datasets/custom.py:45,58, core/loss.py:63) -> defined.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


@dataclass
class SegConfig:
    # ----- Dataset (base_config.py:3-7) -----
    dataset: Optional[str] = None          # 'cityscapes' | 'custom' | 'synthetic'
    data_root: Optional[str] = None
    num_class: int = -1
    ignore_index: int = 255

    # ----- Model (base_config.py:9-13) -----
    model: Optional[str] = None
    encoder: Optional[str] = None          # for model == 'smp' generic enc-dec
    decoder: Optional[str] = None
    encoder_weights: Optional[str] = 'imagenet'
    # offline pretrained backbone import: local torchvision .pth mapped onto
    # the model's 'backbone' scope (replaces the reference's torchvision
    # download side effect, models/backbone.py:7,16)
    backbone_ckpt: Optional[str] = None
    backbone_type: str = 'resnet18'

    # ----- Detail head, STDC (base_config.py:15-20) -----
    use_detail_head: bool = False
    detail_thrs: float = 0.1
    detail_loss_coef: float = 1.0
    dice_loss_coef: float = 1.0
    bce_loss_coef: float = 1.0

    # ----- Training (base_config.py:22-27) -----
    total_epoch: int = 200
    base_lr: float = 0.01
    train_bs: int = 16                     # per device
    use_aux: bool = False
    aux_coef: Optional[Sequence[float]] = None

    # ----- Validation (base_config.py:29-32) -----
    val_bs: int = 16
    begin_val_epoch: int = 0
    val_interval: int = 1

    # ----- Testing / prediction (base_config.py:34-41) -----
    is_testing: bool = False
    test_bs: int = 16
    test_data_folder: Optional[str] = None
    colormap: str = 'cityscapes'
    save_mask: bool = True
    blend_prediction: bool = True
    blend_alpha: float = 0.3

    # ----- Loss (base_config.py:43-46) -----
    loss_type: str = 'ohem'                # 'ce' | 'ohem'
    class_weights: Optional[Sequence[float]] = None
    ohem_thrs: float = 0.7
    reduction: str = 'mean'                # defined here; latent bug in core/loss.py:63

    # ----- Scheduler (base_config.py:48-50) -----
    lr_policy: str = 'cos_warmup'          # 'cos_warmup' | 'linear' | 'step'
    warmup_epochs: int = 3
    step_size: int = 10000                 # for 'step'
    step_gamma: float = 0.1

    # ----- Optimizer (base_config.py:52-55) -----
    optimizer_type: str = 'sgd'            # 'sgd' | 'adam' | 'adamw'
    momentum: float = 0.9
    weight_decay: float = 1e-4

    # ----- Monitoring (base_config.py:57-62) -----
    save_ckpt: bool = True
    save_dir: str = 'save'
    use_tb: bool = True
    # rank-0 progress line every N train steps (reference shows a live tqdm
    # bar, core/seg_trainer.py:36,115-119). 0 disables. The trainer reads
    # the loss LAGGED by one interval (already materialized), so the line
    # never stalls the async dispatch queue — which lets it default on.
    log_interval: int = 50
    tb_log_dir: Optional[str] = None
    ckpt_name: Optional[str] = None
    logger_name: str = 'seg_trainer'
    # jax.profiler trace dump (TPU-native upgrade over the reference's
    # wall-clock-only FPS harness, tools/test_speed.py:29-58): when set,
    # profile_steps train steps of epoch 0 are traced into this directory
    profile_dir: Optional[str] = None
    profile_steps: int = 5

    # ----- Observability (segscope, rtseg_tpu/obs/) -----
    # per-host JSONL telemetry: spans, per-step wall-time breakdown (data
    # wait vs dispatch vs compile), stall events. tools/segscope.py
    # report/diff consumes obs_dir. Off: no files and no watchdog thread;
    # the progress line still shows imgs/sec + data-wait (host timing).
    use_obs: bool = True
    obs_dir: Optional[str] = None          # resolved to save_dir/segscope
    # stall watchdog: heartbeat thread that fires when no step completes
    # within max(watchdog_min_s, watchdog_factor x median recent step
    # time) — dumps every thread's Python stack (+ a short profiler trace
    # when obs_stall_trace) and emits a structured 'stall' event instead
    # of letting a hung collective / tunnel stall die silently
    # (the failure mode utils/bench.py documents)
    watchdog: bool = True
    watchdog_min_s: float = 120.0
    watchdog_factor: float = 20.0
    obs_stall_trace: bool = True
    # sampled on-device profiling (segprof, obs/profile.py): every
    # profile_every train steps, fence the device, trace
    # profile_capture_iters iterations with jax.profiler, parse the
    # trace into per-category/per-module device time + busy fraction,
    # and emit ONE structured 'profile' event into the segscope sink
    # (binary trace deleted after parsing). 0 = off. Non-capture steps
    # pay an integer compare (BENCHMARKS.md "Sampled profiling overhead
    # methodology", segprof_cpu.log). Guard-armed: a capture whose step
    # retraced mid-window is flagged `retraced` and excluded from
    # attribution downstream.
    profile_every: int = 0
    profile_capture_iters: int = 2

    # ----- Input pipeline (segpipe, rtseg_tpu/data/segpipe/) -----
    # packed sample cache: one-time pass that decodes + pre-resizes the
    # dataset (the deterministic prefix of the transform stack) into
    # fixed-shape mmap shards + an index file, content-hashed against
    # dataset files + transform config (auto-invalidated on change). Per
    # epoch, sample cost drops from PNG/JPEG decode to an mmap read +
    # cheap random augment (see BENCHMARKS.md "Loader throughput
    # methodology", segpipe_cpu.log)
    segpipe_cache: bool = False
    cache_dir: Optional[str] = None        # resolved to save_dir/segpack;
    #                                        point at a stable dir to
    #                                        amortize the build across runs
    # multi-process augment workers over a shared-memory ring buffer
    # (replaces the GIL-bound thread pool for the random-crop/flip/jitter
    # stage). 0 = in-process threads (base_workers). Determinism contract
    # is unchanged: per-sample rng is a function of (seed, epoch, process,
    # batch, slot), never of worker scheduling.
    aug_workers: int = 0
    # async device prefetch depth: batches are shipped to the device on a
    # background thread (h2d overlaps device compute) with this many
    # batches in flight. 0 = synchronous per-step transfer (seed-era path).
    device_prefetch: int = 2
    # ship batches as uint8 HWC (4x fewer H2D bytes) and run the
    # normalize/flip tail on-device inside the jit'd step
    # (ops/augment.device_flip_norm — bit-identical to the host
    # transforms.flip_norm_pack path, pinned by tests/test_segpipe.py).
    # None = auto: on whenever the dataset's augment tail supports a raw
    # uint8 handoff (disk datasets with color jitter disabled; the
    # synthetic dataset is float-native so it resolves off). The resolved
    # value lands in device_norm_resolved at get_loader() time.
    device_norm: Optional[bool] = None

    # ----- Warm starts (segwarm, rtseg_tpu/warm/) -----
    # persistent compile cache + serialized AOT executables: the first run
    # pays the XLA compile bill and stores both jax's persistent
    # compilation cache (every jit path) and serialized whole executables
    # (ExeCache: serve buckets, train/eval steps); the second run
    # deserializes and performs zero fresh XLA compiles on those paths
    # (pinned by tests/test_segwarm.py; cold-vs-warm numbers in
    # segwarm_cpu.log). Any cache incompatibility degrades to a fresh
    # compile with a warning — never a crash or a stale hit.
    compile_cache: bool = False
    compile_cache_dir: Optional[str] = None    # resolved to
    #                                            save_dir/segwarm; point at
    #                                            a stable dir to share the
    #                                            warmth across runs/replicas
    # store gates, mirrored into jax_persistent_cache_min_entry_size_bytes
    # / _min_compile_time_secs. Default 0 = cache everything: segwarm's
    # targets (CI jobs, short runs, serving replicas) are exactly the
    # workloads whose compiles fall under jax's default 1 s minimum
    compile_cache_min_entry_bytes: int = 0
    compile_cache_min_compile_secs: float = 0.0
    # ServeEngine bucket-table compilation threads (XLA compile releases
    # the GIL, so cold multi-bucket init scales with cores). 0 = auto:
    # min(len(buckets), os.cpu_count()); 1 = sequential
    compile_workers: int = 0

    # ----- Training setting (base_config.py:64-71) -----
    # torch AMP's role is played by compute_dtype on TPU (bf16 compute, fp32
    # params, no GradScaler). For reference-config migration the flag is
    # wired, not dead: True forces compute_dtype='bfloat16', False forces
    # 'float32', None (default) defers to compute_dtype.
    amp_training: Optional[bool] = None
    # rematerialize the training forward in backward (jax.checkpoint):
    # trades recompute FLOPs for HBM. Whole-forward granularity — coarse;
    # superseded as a batch-unlock lever by the targeted detail_remat /
    # hires_remat flags (BENCHMARKS.md "Generalizing trace-guided remat").
    # For larger inputs the bigger levers are spatial_partition and
    # smaller per-device batch
    remat: bool = False
    resume_training: bool = True
    load_ckpt: bool = True
    load_ckpt_path: Optional[str] = None
    base_workers: int = 8
    random_seed: int = 1
    use_ema: bool = False

    # ----- Augmentation (base_config.py:73-83) -----
    crop_size: int = 512
    crop_h: Optional[int] = None
    crop_w: Optional[int] = None
    scale: float = 1.0
    randscale: Any = 0.0                   # float or (lo, hi) tuple
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    h_flip: float = 0.0
    v_flip: float = 0.0
    # custom-dataset square resize (datasets/custom.py:45,58)
    train_size: Optional[int] = None
    test_size: Optional[int] = None

    # ----- Parallelism (replaces base_config.py:85-86 DDP block) -----
    sync_bn: bool = True                   # cross-replica BN stats via pmean
    mesh_shape: Optional[Sequence[int]] = None   # e.g. (8,) data; (4, 2) data x spatial
    mesh_axes: Sequence[str] = ('data',)
    spatial_partition: int = 1             # >1: shard H across 'spatial' axis
    multihost: bool = False                # call jax.distributed.initialize()
    coordinator_address: Optional[str] = None
    process_id: Optional[int] = None
    num_processes: Optional[int] = None

    # ----- Knowledge distillation (base_config.py:88-96) -----
    kd_training: bool = False
    teacher_ckpt: str = ''
    teacher_model: str = 'smp'
    teacher_encoder: Optional[str] = None
    teacher_decoder: Optional[str] = None
    kd_loss_type: str = 'kl_div'           # 'kl_div' | 'mse'
    kd_loss_coefficient: float = 1.0
    kd_temperature: float = 4.0

    # synthetic-dataset size (train split; val = max(16, len // 4)) for
    # convergence runs and benchmarks without disk data
    synthetic_len: int = 64

    # ----- Numerics (TPU-native additions) -----
    # activations/matmul dtype under jit; None = unset, resolved to
    # 'bfloat16' (the TPU default) unless amp_training overrides — the
    # sentinel lets resolve() tell "explicitly set" from "left at default"
    compute_dtype: Optional[str] = None
    param_dtype: str = 'float32'
    # space-to-depth stem packing: compute 3-channel k3/s2 stem convs as
    # k2/s1 over 12 packed lanes (exact weight-space rewrite, checkpoint-
    # compatible; see nn/modules.py _PackedStemConv)
    s2d_stem: bool = False
    # segnet-only: compute the two full-res 64-ch stages + classifier in
    # S2D(2) layout at eval (exact; halves their HBM lane padding — the
    # bs64 forward OOM hot spot; see models/segnet.py)
    segnet_pack: bool = False
    # bisenetv2-only: rematerialize the DetailBranch in backward (its
    # high-res activations are the biggest train residuals); math
    # identical, frees HBM for lane-filling train batches
    detail_remat: bool = False
    # eval confusion matrix through the shared-memory histogram kernel
    # (ops/pallas_metrics.py, CUDA) instead of the plain bincount — the
    # same exact counts. None = auto: the kernel on a CUDA device, the
    # plain version on the CPU.
    use_pallas_metrics: Optional[bool] = None
    # fused head: the model returns its low-resolution logits
    # (defer_upsample=True) and the eval/predict steps fuse the bilinear
    # upsample with the argmax in one kernel that never materializes the
    # full-resolution logit tensor (ops/fused_head.resize_argmax). Same
    # predictions up to float associativity on near-ties. None = auto: the
    # kernel on a CUDA device, the plain version on the CPU.
    fused_head: Optional[bool] = None
    # stdc/ddrnet/ppliteseg: rematerialize the highest-resolution encoder
    # stages in backward (the generalization of bisenetv2's detail_remat —
    # drop the big early-stage residuals, keep the cheap deep ones). Math
    # identical; param paths unchanged (function-scope nn.remat).
    hires_remat: bool = False
    # runtime recompile guard (analysis/recompile.py): wraps the compiled
    # train/eval/predict steps so that after each step's warmup call, any
    # jit-cache growth — a silent retrace from drifting batch shapes,
    # weak-typed scalars, or trace-time globals — raises RecompileError
    # instead of silently eating an XLA compile on the hot path
    recompile_guard: bool = False
    # bisenetv2: eval-only S2D(2) compute layout for the full-res stem +
    # detail stages (the generalization of segnet_pack — the stem's thin-
    # channel tensors dominate the full-res eval step, BENCHMARKS.md
    # round-4 profile). Exact, same param tree; see nn/packed.py.
    pack_fullres: bool = False

    # ----- Derived fields (filled by resolve(); never set by hand) -----
    device_norm_resolved: bool = False     # set by data.get_loader()
    train_num: int = 0
    val_num: int = 0
    iters_per_epoch: int = 0
    total_itrs: int = 0
    lr: float = 0.0
    gpu_num: int = 1                       # device count (kept for parity of meaning)

    _resolved: bool = False

    # -------------------------------------------------------------- resolve
    def resolve(self, num_devices: Optional[int] = None) -> "SegConfig":
        """Explicit derived-field resolution.

        Replaces reference init_dependent_config (base_config.py:98-109) plus the
        runtime mutations scattered through utils/optimizer.py:9-16 and
        utils/scheduler.py:6-10.
        """
        if self.load_ckpt_path is None and not self.is_testing:
            self.load_ckpt_path = f'{self.save_dir}/last.ckpt'
        if self.tb_log_dir is None:
            self.tb_log_dir = f'{self.save_dir}/tb_logs/'
        if self.obs_dir is None:
            self.obs_dir = f'{self.save_dir}/segscope'
        if self.cache_dir is None:
            self.cache_dir = f'{self.save_dir}/segpack'
        if self.compile_cache_dir is None:
            self.compile_cache_dir = f'{self.save_dir}/segwarm'
        if self.crop_h is None:
            self.crop_h = self.crop_size
        if self.crop_w is None:
            self.crop_w = self.crop_size
        if self.amp_training is not None:
            # migrated reference configs behave predictably: AMP on -> bf16
            # compute, AMP off -> full fp32 (see field comment)
            amp_dtype = 'bfloat16' if self.amp_training else 'float32'
            if self.compute_dtype is not None \
                    and self.compute_dtype != amp_dtype:
                import warnings
                warnings.warn(
                    f'amp_training={self.amp_training} overrides explicitly '
                    f'set compute_dtype={self.compute_dtype!r} -> '
                    f'{amp_dtype!r}; set only one of the two.',
                    stacklevel=2)
            self.compute_dtype = amp_dtype
        elif self.compute_dtype is None:
            self.compute_dtype = 'bfloat16'

        if self.spatial_partition > 1 and self.crop_h is not None \
                and self.crop_h % self.spatial_partition:
            # GSPMD input shardings need the sharded dim divisible by the
            # shard count; fail here with a clear message instead of deep
            # inside pjit
            raise ValueError(
                f'crop_h={self.crop_h} must be divisible by '
                f'spatial_partition={self.spatial_partition} (the spatial '
                f'mesh axis shards image rows)')

        if num_devices is not None:
            self.gpu_num = num_devices
        # linear LR scaling by device count (utils/optimizer.py:9-16)
        if self.optimizer_type == 'sgd':
            self.lr = self.base_lr * self.gpu_num
        elif self.optimizer_type in ('adam', 'adamw'):
            self.lr = 0.001 * self.gpu_num
        else:
            raise NotImplementedError(
                f'Unsupported optimizer type: {self.optimizer_type}')
        self._resolved = True
        return self

    def resolve_schedule(self, train_num: int) -> "SegConfig":
        """Schedule math of utils/scheduler.py:6-10: per-iteration stepping with
        total steps = ceil(train_num / bs / devices) * epochs."""
        import math
        self.train_num = train_num
        self.iters_per_epoch = max(
            1, math.ceil(train_num / self.train_bs / self.gpu_num))
        self.total_itrs = int(self.total_epoch * self.iters_per_epoch)
        return self

    # ---------------------------------------------------------------- misc
    def replace(self, **kw) -> "SegConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop('_resolved', None)
        return d

    def save(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=4, default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "SegConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a feature of the JAX package that the port does not
    have yet, naming the ROADMAP.md Queue 1 item that brings it."""
    return NotImplementedError(f'{what} is not ported to PyTorch yet (see '
                               f'ROADMAP.md Queue 1, "{item}")')


def refuse_unported(config, switches) -> None:
    """The port's rule for a switch of the JAX package that it does not
    implement yet: it raises, never is ignored. `switches` holds (flag,
    whether a value asks for the feature, what the feature is, the title
    of the ROADMAP.md Queue 1 item that brings it)."""
    for flag, asks, what, item in switches:
        value = getattr(config, flag)
        if asks(value):
            raise NotImplementedError(
                f'{flag}={value!r}: {what} is not ported to PyTorch yet; '
                f'leave it at its default (see ROADMAP.md Queue 1, '
                f'"{item}")')
