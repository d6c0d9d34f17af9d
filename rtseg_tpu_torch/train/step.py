"""Train, eval and predict steps (counterpart of rtseg_tpu/train/step.py:
_make_forward_loss and build_train_step, build_eval_step,
build_predict_step).

The train step casts the images to config.compute_dtype, runs the model in
training mode (plain; with the aux heads, whose losses take the labels
nearest-resized to each head's resolution; or with STDC's detail head),
adds the KD term under kd_training (the frozen teacher, in eval mode and
without autograd, on the same compute-dtype images; its logits against
the student's main logits, weighted by config.kd_loss_coefficient),
backpropagates the loss into float32 gradients, writes the step's LR and
momentum (SGD) or beta1 (Adam, AdamW) into the param group, updates, and
moves the EMA model.

In a process group (data parallel, parallel/mesh.py) each rank runs the
step on its slice of the global batch, and the step does what the JAX
step does under shard_map: after the backward one all-reduce of every
gradient through one flat float32 buffer, SUM then divided by the world
size (the JAX step's `lax.pmean(grads)`), before the update; under
config.sync_bn the BatchNorms average their batch statistics over the
ranks in the forward and, through the all-reduce's backward, their
gradients (nn/modules.py `sync_batch_norm`; a rematerialized forward's
recompute syncs again, on the same inputs); without sync_bn each rank
normalizes with its own statistics and the running statistics are
averaged after the update. OHEM and the KD term stay per rank. The
returned loss is the rank's own: the trainer averages it over the ranks
where it reads it, not each step. With no group no collective is issued;
a group of one rank gives the same bits as none (a sum over one rank is
a copy, and the division by 1 is exact).

With config.remat the model's training forward, and only it, runs under
torch.utils.checkpoint (non-reentrant), as the JAX step wraps
model.apply alone in jax.checkpoint: the loss, the detail targets and the
KD teacher stay outside. Its recompute in the backward leaves BatchNorm's
running statistics alone and replays the first pass's dropout and
drop-path masks (nn/modules.py `Recompute`), so the step equals the one
without remat.

With norm_coeffs=(scale, bias) the steps take uint8 HWC batches (the raw
tail of a loader): the train step opens with the per-sample flips of its
[B, 2] uint8 flag plane and the normalize by table (ops/augment.py), the
eval and predict steps with the normalize alone, bit-equal to the host's
float32 batches.

The models with dropout (ENet, MiniNet) draw their keep masks from a
torch.Generator on the batch's device that the step seeds from
config.random_seed + 1, the step number and the rank (`dropout_seed`), as
the JAX step folds the step and the shard's index into
PRNGKey(random_seed + 1): a resumed run draws the masks an uninterrupted
one draws, and rank 0 draws those of one process. The masks cannot equal
the JAX package's (Flax folds the module path into a threefry key), so
tests and the card-against-CPU check hand the step their own through
`dropout_masks`.

Every parameter enters the update with a gradient, zero where autograd left
none (STDC's `detail_conv`, which only makes the detail targets): torch's
optimizers skip a parameter whose gradient is None, where the JAX
package's optax chain decays every leaf and moves its momentum or Adam
moments.

The eval step casts the images to config.compute_dtype, runs the model with
its final upsample deferred when the fused head is on, computes the int32
predictions with the fused upsample+argmax (ops/fused_head.py, or a plain
argmax over materialized logits when the fused head is off) and counts
them into a (C, C) int32 confusion matrix (ops/pallas_metrics.py, or the
plain bincount) of the rank's batch; SegTrainer.validate sums the ranks'
matrices once, at the end.

Each step carries `_cache_size()`: the number of distinct (shape, dtype,
device) signatures of the tensors it has been called with, the
counterpart of the JAX jit-cache size that obs/collector.py reads. The
first call of a signature is where eager PyTorch pays its one-time costs
(cuDNN's algorithm search under cudnn.benchmark, lazy module loading, the
first build or load of the kernels), so the step collector flags that step
`compile` as the JAX collector flags a step that grew the jit cache.
Each step also carries the JAX step wrappers' pins (`bn_axis`,
`s2d_stem`, `defer_upsample`) and `kernels`, the CUDA kernel libraries it
launches, which warm/prime.py's warm_step acquires through the compile
cache.

bf16 runs the way the JAX package runs it: bf16 activations, float32
weights cast to bf16 per conv call, BatchNorm in float32 on float32
statistics (nn/modules.py). That is explicit in the modules rather than
left to torch.autocast, whose thread-local mode would be a process-global
switch of the kind the port avoids, and whose op lists decide casts by op
name rather than by the JAX package's rules.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses import (get_detail_loss_fn, get_kd_loss_fn, get_loss_fn,
                      laplacian_pyramid)
from ..nn.modules import (DropoutMasks, Recompute, batch_norms,
                          bind_dropout, dropout_modules, sync_batch_norm)
from ..ops.augment import flip_norm, norm_table, normalize
from ..ops.fused_head import resize_argmax
from ..ops.pallas_metrics import confusion_matrix_pallas
from ..ops.resize import resize_bilinear, resize_nearest
from ..parallel import (all_reduce_mean_grad, average_, is_distributed,
                        process_index)
from ..utils.metrics import confusion_matrix
from .optim import get_lr_schedule, optimizer_momentum, set_hparams
from .state import TrainState, ema_mirror, ema_update


def _resolve(flag: Optional[bool], device: torch.device) -> bool:
    """A kernel switch of the config: None (auto) means the kernel on a
    CUDA device and the plain version on the CPU."""
    return device.type == 'cuda' if flag is None else bool(flag)


def compute_dtype(config) -> torch.dtype:
    return dtype_named(config.compute_dtype)


def dtype_named(name: Optional[str]) -> torch.dtype:
    """The torch type of a config's compute_dtype (None: bfloat16)."""
    name = name or 'bfloat16'
    if name not in ('float32', 'bfloat16'):
        raise ValueError(f'compute_dtype {name!r}: the port runs float32 '
                         f'or bfloat16')
    return getattr(torch, name)


def _make_apply_train(config) -> Callable:
    """apply_train(model, x): the training forward, under
    torch.utils.checkpoint with config.remat (`Recompute` for its
    contexts, made once a model)."""
    if not config.remat:
        return lambda model, x: model(x)
    recompute = [None, None]    # the last model seen and its Recompute

    def apply_train(model, x):
        if recompute[0] is not model:
            recompute[:] = [model, Recompute(model)]
        return checkpoint(model, x, use_reentrant=False,
                          context_fn=recompute[1])
    return apply_train


def _make_forward_loss(config, teacher=None) -> Callable:
    """forward_loss(model, images, masks) -> (float32 loss, metrics): cast
    to the compute dtype, training forward (rematerialized with
    config.remat), the loss and the aux or detail losses, and under
    kd_training the KD term of `teacher` (a frozen model in eval mode);
    metrics holds `loss_detail` with the detail head and `loss_kd` with
    KD."""
    if config.kd_training and teacher is None:
        raise ValueError('kd_training needs the teacher model')
    kd_fn = get_kd_loss_fn(config) if config.kd_training else None
    loss_fn = get_loss_fn(config)
    detail_loss_fn = get_detail_loss_fn(config)
    dtype = compute_dtype(config)
    apply_train = _make_apply_train(config)

    def forward_loss(model, images, masks):
        x = images.to(dtype)
        out = apply_train(model, x)
        metrics = {}
        if config.use_aux:
            preds, preds_aux = out
            loss = loss_fn(preds, masks)
            coefs = config.aux_coef if config.aux_coef is not None \
                else (1.0,) * len(preds_aux)
            if len(coefs) != len(preds_aux):
                raise ValueError(
                    'Auxiliary loss coefficient length does not match.')
            for coef, pa in zip(coefs, preds_aux):
                ms = resize_nearest(masks[..., None], pa.shape[1:3])[..., 0]
                loss = loss + coef * loss_fn(pa, ms)
        elif config.use_detail_head:
            preds, preds_detail = out
            loss = loss_fn(preds, masks)
            # detail targets: the Laplacian pyramid of the masks through the
            # model's own detail_conv on detached weights, hard-thresholded
            with torch.no_grad():
                dgt = model.detail_targets(laplacian_pyramid(masks))
            dgt = (dgt > config.detail_thrs).float()
            pd = resize_bilinear(preds_detail, dgt.shape[1:3],
                                 align_corners=True)
            loss_detail = detail_loss_fn(pd.float(), dgt)
            metrics['loss_detail'] = loss_detail.detach()
            loss = loss + config.detail_loss_coef * loss_detail
        else:
            preds = out
            loss = loss_fn(preds, masks)
        if kd_fn is not None:
            with torch.no_grad():
                t_out = teacher(x)
            loss_kd = kd_fn(preds, t_out)
            metrics['loss_kd'] = loss_kd.detach()
            loss = loss + config.kd_loss_coefficient * loss_kd
        return loss, metrics

    return forward_loss


_GOLDEN64 = 0x9E3779B97F4A7C15       # 2^64 / the golden ratio, odd


def dropout_seed(random_seed: int, step: int, rank: int = 0) -> int:
    """The seed of step `step`'s dropout generator on rank `rank`:
    random_seed + 1 and the step, one 64-bit number, plus the rank times
    an odd 64-bit constant (rank 0 keeps the seed of one process)."""
    return ((((int(random_seed) + 1) << 32) + int(step))
            + int(rank) * _GOLDEN64) % (1 << 64)


def _signatures(step: Callable) -> Callable:
    """Attach `step._cache_size()` and return `note(*tensors)`, which a
    step calls with its tensor arguments (None allowed) to record their
    signature."""
    seen = set()

    def note(*tensors) -> None:
        seen.add(tuple(None if t is None else
                       (tuple(t.shape), t.dtype, t.device)
                       for t in tensors))

    step._cache_size = lambda: len(seen)
    return note


def _pin(step: Callable, config, bn_axis=None, defer_upsample: bool = False,
         kernels=()) -> None:
    """The step's pins, as the JAX step wrappers carry them (bn_axis,
    s2d_stem, defer_upsample: the cache key's PIN_KEYS,
    warm/prime.py), and the CUDA kernel libraries it launches
    (`kernels`, acquired by warm/prime.py warm_step)."""
    step.bn_axis = bn_axis
    step.s2d_stem = bool(getattr(config, 's2d_stem', False))
    step.defer_upsample = defer_upsample
    step.kernels = tuple(kernels)


def _kernels(device: torch.device, fused: bool, pallas_cm: bool) -> tuple:
    """The kernel libraries an eval or predict step launches on `device`
    (none on the CPU, where the wrappers take their plain versions)."""
    if device.type != 'cuda':
        return ()
    return tuple(name for name, on in (('fused_head', fused),
                                       ('confusion_matrix', pallas_cm))
                 if on)


def _running_stats(norms) -> list:
    return ([m.bn.running_mean for m in norms]
            + [m.bn.running_var for m in norms])


def build_train_step(config, norm_coeffs=None,
                     dropout_masks: Optional[Callable] = None,
                     teacher: Optional[torch.nn.Module] = None) -> Callable:
    """train_step(state, images [B,H,W,3], masks [B,H,W]) -> (state,
    {'loss': 0-dim float32 tensor on the device, 'loss_detail' with the
    detail head, 'loss_kd' with KD}); updates `state` in place. Nothing is
    read back. `teacher` is the frozen KD teacher under kd_training (the
    trainer's, in eval mode).

    With `norm_coeffs=(scale, bias)`: train_step(state, images_u8, masks,
    flags), the images uint8 and flags [B, 2] uint8 (h_flip, v_flip), the
    batch flipped and normalized on its device first (ops/augment.py).

    `dropout_masks(step)`, where given, returns the mask source
    (nn/modules.py `MaskSource`) of that step in place of the masks drawn
    from the step's generator: the seam through which tests hand the port
    the masks they hand the JAX package, and the card-against-CPU check
    the same masks on both devices."""
    forward_loss = _make_forward_loss(config, teacher)
    lr_fn = get_lr_schedule(config)
    mom = optimizer_momentum(config)
    total_itrs = np.float32(max(int(config.total_itrs), 1))
    # the last model seen, its dropout modules and its BatchNorms
    mods = [None, [], []]
    generators = {}       # device -> the step's dropout generator
    tables = {}           # device -> the normalize table of norm_coeffs

    def drawn_masks(device: torch.device, step: int) -> DropoutMasks:
        g = generators.get(device)
        if g is None:
            g = generators[device] = torch.Generator(device=device)
        g.manual_seed(dropout_seed(config.random_seed, step,
                                   process_index()))
        return DropoutMasks(g)

    def train_step(state: TrainState, images: torch.Tensor,
                   masks: torch.Tensor, flags: Optional[torch.Tensor] = None):
        note(images, masks, flags)
        if norm_coeffs is not None:
            table = tables.get(images.device)
            if table is None:
                table = tables[images.device] = norm_table(*norm_coeffs,
                                                           images.device)
            images, masks = flip_norm(images, masks, flags, table)
        elif flags is not None:
            raise ValueError('flip flags need the step built with '
                             'norm_coeffs')
        model, k = state.model, state.step
        model.train()
        set_hparams(state.optimizer, lr_fn(k),
                    mom(k) if callable(mom) else mom)
        state.optimizer.zero_grad(set_to_none=True)
        if mods[0] is not model:
            mods[:] = [model, dropout_modules(model), batch_norms(model)]
        drops, norms = mods[1], mods[2]
        group = is_distributed()
        # synced statistics through the forward and the backward (where
        # a rematerialized forward's recompute runs)
        with (sync_batch_norm(norms, all_reduce_mean_grad)
              if group and config.sync_bn else nullcontext()):
            if drops:
                source = (dropout_masks(k) if dropout_masks is not None
                          else drawn_masks(images.device, k))
                with bind_dropout(model, source, drops):
                    loss, metrics = forward_loss(model, images, masks)
            else:
                loss, metrics = forward_loss(model, images, masks)
            loss.backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if group:
            # the JAX step's one lax.pmean(grads)
            average_([p.grad for p in params])
        state.optimizer.step()
        if group and not config.sync_bn:
            # replicated running statistics from per-rank normalization
            average_(_running_stats(norms))
        state.step = k + 1
        if config.use_ema:
            # ramp decay (reference utils/model_ema.py:35-40)
            decay = np.clip(np.float32(state.step) / total_itrs, 0, 1)
            ema_update(model, state.ema_model, decay)
        else:
            ema_mirror(model, state.ema_model)
        return state, {**metrics, 'loss': loss.detach()}

    note = _signatures(train_step)
    # the port's one mesh axis, as the JAX step's sync_bn axes
    _pin(train_step, config, bn_axis=('data',) if config.sync_bn else None)
    return train_step


def _predict(model, images, dtype, fused: bool) -> torch.Tensor:
    out = model(images.to(dtype), defer_upsample=fused)
    if fused:
        # deferred low-res logits -> fused upsample+argmax at the label
        # resolution (identity shortcut if the logits are already full-res)
        return resize_argmax(out.contiguous(), images.shape[1:3])
    return torch.argmax(out, dim=-1).to(torch.int32)


def _normalizer(norm_coeffs, device) -> Callable:
    """images -> images: the normalize of uint8 batches by norm_coeffs'
    table on `device`, or the identity without norm_coeffs."""
    if norm_coeffs is None:
        return lambda images: images
    table = norm_table(*norm_coeffs, device)
    return lambda images: normalize(images, table)


def build_eval_step(config, model, device, norm_coeffs=None) -> Callable:
    """eval_step(images [B,H,W,3], masks [B,H,W]) -> (C, C) int32
    confusion matrix on `device`; with `norm_coeffs` the images are uint8
    and normalized on the device first (no flips)."""
    device = torch.device(device)
    prepare = _normalizer(norm_coeffs, device)
    dtype = compute_dtype(config)
    fused = _resolve(config.fused_head, device)
    pallas_cm = _resolve(config.use_pallas_metrics, device)
    cm_fn = confusion_matrix_pallas if pallas_cm else confusion_matrix
    num_class, ignore = config.num_class, config.ignore_index

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        note(images, masks)
        preds = _predict(model, prepare(images), dtype, fused)
        return cm_fn(preds, masks, num_class, ignore)

    eval_step.fused = fused
    note = _signatures(eval_step)
    _pin(eval_step, config, defer_upsample=fused,
         kernels=_kernels(device, fused, pallas_cm))
    return eval_step


def build_predict_step(config, model, device, norm_coeffs=None) -> Callable:
    """predict_step(images [B,H,W,3]) -> int32 predictions [B,H,W], with the
    same fused-head and norm_coeffs policy as build_eval_step."""
    device = torch.device(device)
    prepare = _normalizer(norm_coeffs, device)
    dtype = compute_dtype(config)
    fused = _resolve(config.fused_head, device)

    @torch.inference_mode()
    def predict_step(images: torch.Tensor) -> torch.Tensor:
        note(images)
        return _predict(model, prepare(images), dtype, fused)

    predict_step.fused = fused
    note = _signatures(predict_step)
    _pin(predict_step, config, defer_upsample=fused,
         kernels=_kernels(device, fused, False))
    return predict_step
