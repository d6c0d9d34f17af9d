"""The inference head of serving (counterpart of rtseg_tpu/export.py:
build_inference_fn).

``build_inference_fn`` is the function the serving engine captures a CUDA
graph of (serve/engine.py): the images cast to the compute dtype, the
model in eval mode with its own full-resolution upsample (never deferred
to the fused head), the logits in float32, and the channel argmax as int8,
the reference's ONNX export head (ddrnet.py:56-58). The StableHLO artifact
of the JAX package (``export_model``, ``save_exported``,
``load_exported``; ``torch.export`` in the port) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from .config import not_ported
from .train.step import dtype_named


def build_inference_fn(model: torch.nn.Module, compute_dtype,
                       argmax: bool = True) -> Callable:
    """fn(images f32[B, H, W, 3]) -> int8[B, H, W] masks (``argmax``) or
    float32 logits [B, H, W, C], without autograd. ``model`` must be in
    eval mode; ``compute_dtype`` is a config's name (None: bfloat16)."""
    if model.training:
        raise ValueError('build_inference_fn needs the model in eval mode')
    dtype = dtype_named(compute_dtype)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        logits = model(images.to(dtype), defer_upsample=False).float()
        if argmax:
            return torch.argmax(logits, dim=-1).to(torch.int8)
        return logits

    return fn


def export_model(*args, **kwargs):
    raise not_ported('export_model (torch.export)', 'The planes')


def save_exported(*args, **kwargs):
    raise not_ported('save_exported (torch.export)', 'The planes')


def load_exported(*args, **kwargs):
    raise not_ported('load_exported (torch.export)', 'The planes')
