"""Eval and predict steps (counterpart of the eval side of
rtseg_tpu/train/step.py: build_eval_step, build_predict_step).

The eval step casts the images to config.compute_dtype, runs the model with
its final upsample deferred when the fused head is on, computes the int32
predictions with the fused upsample+argmax (ops/fused_head.py, or a plain
argmax over materialized logits when the fused head is off) and counts
them into a (C, C) int32 confusion matrix (ops/pallas_metrics.py, or the
plain bincount). One card: no cross-device reduction.

bf16 runs the way the JAX package runs it: bf16 activations, float32
weights cast to bf16 per conv call, BatchNorm in float32 on float32
statistics (nn/modules.py). That is explicit in the modules rather than
left to torch.autocast, whose thread-local mode would be a process-global
switch of the kind the port avoids, and whose op lists decide casts by op
name rather than by the JAX package's rules.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.fused_head import resize_argmax
from ..ops.pallas_metrics import confusion_matrix_pallas
from ..utils.metrics import confusion_matrix


def _resolve(flag: Optional[bool], device: torch.device) -> bool:
    """A kernel switch of the config: None (auto) means the kernel on a
    CUDA device and the plain version on the CPU."""
    return device.type == 'cuda' if flag is None else bool(flag)


def compute_dtype(config) -> torch.dtype:
    name = config.compute_dtype or 'bfloat16'
    if name not in ('float32', 'bfloat16'):
        raise ValueError(f'compute_dtype {name!r}: the port runs float32 '
                         f'or bfloat16')
    return getattr(torch, name)


def _predict(model, images, dtype, fused: bool) -> torch.Tensor:
    out = model(images.to(dtype), defer_upsample=fused)
    if fused:
        # deferred low-res logits -> fused upsample+argmax at the label
        # resolution (identity shortcut if the logits are already full-res)
        return resize_argmax(out.contiguous(), images.shape[1:3])
    return torch.argmax(out, dim=-1).to(torch.int32)


def build_eval_step(config, model, device) -> Callable:
    """eval_step(images [B,H,W,3], masks [B,H,W]) -> (C, C) int32
    confusion matrix on `device`."""
    device = torch.device(device)
    dtype = compute_dtype(config)
    fused = _resolve(config.fused_head, device)
    cm_fn = (confusion_matrix_pallas
             if _resolve(config.use_pallas_metrics, device)
             else confusion_matrix)
    num_class, ignore = config.num_class, config.ignore_index

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        preds = _predict(model, images, dtype, fused)
        return cm_fn(preds, masks, num_class, ignore)

    eval_step.fused = fused
    return eval_step


def build_predict_step(config, model, device) -> Callable:
    """predict_step(images [B,H,W,3]) -> int32 predictions [B,H,W], with the
    same fused-head policy as build_eval_step."""
    device = torch.device(device)
    dtype = compute_dtype(config)
    fused = _resolve(config.fused_head, device)

    @torch.inference_mode()
    def predict_step(images: torch.Tensor) -> torch.Tensor:
        return _predict(model, images, dtype, fused)

    predict_step.fused = fused
    return predict_step
