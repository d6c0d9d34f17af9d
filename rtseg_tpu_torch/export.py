"""Serving export (counterpart of rtseg_tpu/export.py).

The reference exports models by switching the forward to an int8-argmax
head under ``torch.onnx.is_in_onnx_export()`` (reference
models/ddrnet.py:55-58). The JAX package lowers its jitted inference
function to StableHLO with ``jax.export``; the port exports the same
function with ``torch.export``: the weights are stored with the program,
and ``torch.export.save`` writes a ``.pt2`` artifact that any PyTorch
runtime reloads and runs without the model-building code.

API:
  * ``build_inference_fn(model, compute_dtype, argmax)``: the function the
    serving engine captures a CUDA graph of;
  * ``export_model(config, ...) -> torch.export.ExportedProgram``, and
    ``export_module`` for any inference module (the int8 one of quant/);
  * ``save_exported / load_exported``: the ``.pt2`` on disk and back,
    onto the card unless the CPU is named;
  * ``artifact_input_shape(exported)``: the (batch, H, W) the program
    takes, the batch None when it is symbolic.

A program is exported on the CPU (tracing needs no card), and
``load_exported`` moves it to the device it will run on. ``platforms``
names the devices an artifact may be loaded on: ``cpu`` and ``cuda``. The
port has no TPU target, so ``tpu`` raises.

CLI: ``python tools/torch_export.py --model ddrnet --num_class 19 ...``
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import torch

from .train.step import dtype_named

SUFFIX = '.pt2'
#: the devices a program may be exported for
PLATFORMS = ('cpu', 'cuda')
_PLATFORMS_FILE = 'rtseg_platforms'


def build_inference_fn(model: torch.nn.Module, compute_dtype,
                       argmax: bool = True) -> Callable:
    """fn(images f32[B, H, W, 3]) -> int8[B, H, W] masks (``argmax``) or
    float32 logits [B, H, W, C], without autograd: the images cast to the
    compute dtype, the model in eval mode with its own full-resolution
    upsample (never deferred to the fused head), the logits in float32,
    and the channel argmax as int8, the reference's ONNX export head
    (ddrnet.py:56-58). ``model`` must be in eval mode; ``compute_dtype``
    is a config's name (None: bfloat16)."""
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


class InferenceModule(torch.nn.Module):
    """``build_inference_fn`` as a module, the form `torch.export` takes:
    the model (and so its weights) is a submodule."""

    def __init__(self, model: torch.nn.Module, compute_dtype,
                 argmax: bool = True):
        super().__init__()
        self.model = model
        self.fn = build_inference_fn(model, compute_dtype, argmax)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.fn(images)


def _platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    platforms = tuple(platforms)
    if not platforms:
        raise ValueError('export: no platforms')
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(
                f'export: platform {p!r} is not one of the port\'s '
                f'{", ".join(PLATFORMS)}' + (' (the port has no TPU target)'
                                             if p == 'tpu' else ''))
    return platforms


def export_module(module: torch.nn.Module, imgh: int, imgw: int,
                  batch: Optional[int] = 1,
                  platforms: Sequence[str] = PLATFORMS
                  ) -> torch.export.ExportedProgram:
    """`torch.export` of an inference module (images f32[B, imgh, imgw, 3]
    in) on the CPU. ``batch=None`` exports a symbolic batch dimension, so
    one artifact serves any batch size; H and W stay static. The program
    keeps ``platforms`` for `save_exported`."""
    platforms = _platforms(platforms)
    if batch is None:
        # a symbolic batch is traced at 2: torch.export specializes 0 and 1
        example = torch.zeros((2, imgh, imgw, 3))
        dynamic = ({0: torch.export.Dim('b', min=1)},)
    else:
        example = torch.zeros((int(batch), imgh, imgw, 3))
        dynamic = None
    with torch.no_grad():
        exported = torch.export.export(module, (example,),
                                       dynamic_shapes=dynamic)
    # the example is no part of the program, and torch.export.save would
    # store it (200 MB of zeros at 1024x2048 x8)
    exported.example_inputs = None
    exported.platforms = platforms
    return exported


def export_model(config, imgh: int = 512, imgw: int = 1024,
                 batch: Optional[int] = 1, argmax: bool = True,
                 ckpt_path: Optional[str] = None,
                 platforms: Sequence[str] = PLATFORMS
                 ) -> torch.export.ExportedProgram:
    """Export the configured model's inference function (``argmax``: the
    int8 mask head, else float32 logits) on the CPU. Weights: a
    checkpoint of the port at ``ckpt_path`` over Flax's initializers, else
    Flax's initializers alone drawn from seed 0 (ServeEngine.from_config's
    rule; not the JAX package's PRNGKey(0) values)."""
    from .models.registry import get_model
    from .train.checkpoint import restore_weights
    from .utils.convert import flax_init_variables, load_jax_variables

    platforms = _platforms(platforms)
    model = get_model(config, device='cpu').eval()
    load_jax_variables(model, flax_init_variables(model, 0))
    if ckpt_path:
        restore_weights(ckpt_path, model)
    return export_module(InferenceModule(model, config.compute_dtype,
                                         argmax),
                         imgh, imgw, batch, platforms)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> str:
    if not path.endswith(SUFFIX):
        path += SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    platforms = getattr(exported, 'platforms', PLATFORMS)
    torch.export.save(exported, path,
                      extra_files={_PLATFORMS_FILE: ','.join(platforms)})
    return path


def load_exported(path: str, device=None) -> torch.export.ExportedProgram:
    """The artifact at ``path`` on ``device`` (the card unless the CPU is
    named). A device whose type the artifact was not exported for
    raises."""
    from .serve.engine import resolve_device
    device = resolve_device(device)
    extra = {_PLATFORMS_FILE: ''}
    exported = torch.export.load(path, extra_files=extra)
    platforms = tuple(p for p in extra[_PLATFORMS_FILE].split(',') if p) \
        or PLATFORMS
    if device.type not in platforms:
        raise ValueError(f'artifact {path} was exported for '
                         f'{", ".join(platforms)}, not {device.type}')
    if device.type != 'cpu':
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, device)
    exported.platforms = platforms
    return exported


def artifact_input_shape(exported: torch.export.ExportedProgram
                         ) -> Tuple[Optional[int], int, int]:
    """(batch, H, W) of the program's image input; batch None when it is
    symbolic."""
    name = exported.graph_signature.user_inputs[0]
    node = next(n for n in exported.graph.nodes
                if n.op == 'placeholder' and n.name == name)
    b, h, w = tuple(node.meta['val'].shape)[:3]
    return (b if isinstance(b, int) else None), int(h), int(w)


def exported_fn(exported: torch.export.ExportedProgram) -> Callable:
    """The program as a function of the images, without autograd."""
    module = exported.module()

    def fn(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(images)

    return fn
