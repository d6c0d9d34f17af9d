"""Deterministic calibration and the QuantRecord quality gate (counterpart
of rtseg_tpu/quant/calibrate.py).

Calibration runs the real eval forward (export.build_inference_fn: the
serving head, int8 argmax) twice over one deterministic sample slice: once
with the f32 weights, once with the quantized tree. What comes out:

  * ``agreement_frac``: the fraction of pixels whose argmax matches
    between the two forwards;
  * the mIoU delta: against ground-truth masks when the slice comes from a
    segpipe PackedCache, or against the f32 forward's own masks for the
    synthetic source (recorded as ``reference: f32_forward``);
  * the calibration hash: sha256 over the exact sample bytes + seed +
    indices.

The forwards run on the model's device (the card unless the caller built
the model on the CPU); the mIoU is host numpy, as in the JAX package. The
``weights`` and ``calib`` sections are computed on the host from the
Flax-shaped tree and the sample bytes, so they are the JAX package's,
byte for byte, on the same weights and samples.

The record is a plain JSON-able dict; :func:`record_to_json` is the one
serializer (sorted keys, fixed indent).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .ptq import (QMAX, build_quantized_inference_fn, quantized_nbytes,
                  scale_fingerprint)

#: a QuantRecord is a plain dict (see :func:`calibrate` for the schema)
QuantRecord = Dict[str, Any]


def select_calibration_indices(n_total: int, n_samples: int,
                               seed: int = 0) -> List[int]:
    """Seeded sample-without-replacement over ``range(n_total)``, sorted
    ascending (shard-sequential reads on a PackedCache)."""
    n = min(int(n_samples), int(n_total))
    rng = np.random.default_rng(seed)
    return sorted(int(i) for i in
                  rng.choice(int(n_total), size=n, replace=False))


def calibration_hash(images: np.ndarray, masks: Optional[np.ndarray],
                     seed: int, indices: Optional[Sequence[int]]) -> str:
    """sha256 over the exact calibration inputs."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(images).tobytes())
    if masks is not None:
        h.update(np.ascontiguousarray(masks).tobytes())
    h.update(json.dumps({'seed': int(seed),
                         'indices': [int(i) for i in indices or []]},
                        sort_keys=True).encode())
    return h.hexdigest()


def _np_miou(pred: np.ndarray, ref: np.ndarray, num_class: int) -> float:
    """Host-side mIoU (JaccardIndex semantics, classes absent from both
    excluded)."""
    pred = pred.reshape(-1).astype(np.int64)
    ref = ref.reshape(-1).astype(np.int64)
    valid = (ref >= 0) & (ref < num_class)
    cm = np.bincount(ref[valid] * num_class + pred[valid],
                     minlength=num_class * num_class
                     ).reshape(num_class, num_class)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    present = union > 0
    if not present.any():
        return 1.0
    return float(np.mean(inter[present] / union[present]))


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _scale(maxabs: float) -> float:
    return (maxabs / QMAX) if maxabs > 0 else 1.0


def _flax_key(name: str) -> str:
    """The capture_intermediates path of the module named `name`."""
    return '/'.join(name.split('.') + ['__call__']) if name else '__call__'


def activation_scales(model: torch.nn.Module, variables, images,
                      compute_dtype) -> Dict[str, float]:
    """Per-tensor symmetric scales (maxabs/127) of every module output of
    the eval forward over the calibration slice, taken with forward
    hooks. Keys are Flax's: the module's scope path '/'-joined, then
    '__call__' (the model's own output is '__call__'), an index a call
    where a module runs more than once and an index an element of a
    tuple output, as the JAX package walks flax's
    ``capture_intermediates``. Values are python floats so the record
    stays JSON-able. ``variables`` (a Flax-shaped tree) is loaded into
    ``model`` first unless None."""
    from ..nn.modules import Conv, Dropout
    from ..train.step import dtype_named
    from ..utils.convert import load_jax_variables
    if variables is not None:
        load_jax_variables(model, variables)
    calls: Dict[str, list] = {}
    hooks = []
    for name, module in model.named_modules():
        keys = [_flax_key(name)]
        # the port's Conv and Dropout (Dropout2d too) do the work of the
        # inner module that Flax's wrap, call and return the output of
        for cls, inner in ((Conv, 'conv'), (Dropout, 'drop')):
            if isinstance(module, cls):
                keys.append(_flax_key(f'{name}.{inner}' if name else inner))

        def hook(_m, _args, output, keys=keys):
            for key in keys:
                calls.setdefault(key, []).append(output)
        hooks.append(module.register_forward_hook(hook))
    x = torch.as_tensor(np.asarray(images, np.float32)).to(_device(model))
    try:
        with torch.no_grad():
            model(x.to(dtype_named(compute_dtype)), defer_upsample=False)
    finally:
        for h in hooks:
            h.remove()
    out: Dict[str, float] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),) if len(node) > 1 else path)
        elif isinstance(node, torch.Tensor):
            out['/'.join(path)] = _scale(float(node.abs().max()))
    for key in sorted(calls):
        walk(tuple(calls[key]), tuple(key.split('/')))
    return out


def calibrate(model: torch.nn.Module, variables, qvariables,
              images: np.ndarray, masks: Optional[np.ndarray] = None, *,
              compute_dtype='float32', num_class: int = 19,
              max_drop: float = 0.05, activations: bool = False,
              source: str = 'synthetic', seed: int = 0,
              indices: Optional[Sequence[int]] = None) -> QuantRecord:
    """Run the f32 and int8 eval forwards over one calibration slice on
    the model's device and emit the QuantRecord. ``model`` is the port's
    module in eval mode; ``variables`` its Flax-shaped f32 tree (loaded
    into it unless None), ``qvariables`` the quantized one. ``images`` is
    the preprocessed (N, H, W, 3) f32 batch; ``masks`` (N, H, W) int
    ground truth when the slice comes from a real cache. The record
    carries the gate verdict; enforcing it is the caller's job."""
    from ..export import build_inference_fn
    from ..utils.convert import load_jax_variables

    images = np.ascontiguousarray(np.asarray(images, np.float32))
    if variables is not None:
        load_jax_variables(model, variables)
    f32_fn = build_inference_fn(model, compute_dtype, argmax=True)
    input_scale = None
    act: Optional[Dict[str, Any]] = None
    if activations:
        scales = activation_scales(model, None, images, compute_dtype)
        input_scale = _scale(float(np.max(np.abs(images))))
        act = {'input_scale': input_scale,
               'tensors': len(scales), 'scales': scales}
    int8_fn = build_quantized_inference_fn(
        model, qvariables, compute_dtype, argmax=True,
        input_scale=input_scale)
    x = torch.from_numpy(images).to(_device(model))
    pred_f32 = f32_fn(x).cpu().numpy()
    pred_int8 = int8_fn(x).cpu().numpy()
    del int8_fn
    agreement = float((pred_f32 == pred_int8).mean())
    if masks is not None:
        miou_f32 = _np_miou(pred_f32, np.asarray(masks), num_class)
        miou_int8 = _np_miou(pred_int8, np.asarray(masks), num_class)
        miou = {'reference': 'ground_truth', 'f32': miou_f32,
                'int8': miou_int8, 'drop': miou_f32 - miou_int8}
    else:
        # no ground truth on this slice: the f32 forward is the
        # reference, and the 'drop' is 1 - mIoU(int8, f32)
        vs = _np_miou(pred_int8, pred_f32, num_class)
        miou = {'reference': 'f32_forward', 'f32': 1.0, 'int8': vs,
                'drop': 1.0 - vs}
    sizes = quantized_nbytes(qvariables['params'])
    record: QuantRecord = {
        'precision': 'int8',
        'weights': {**sizes,
                    'scale_sha256': scale_fingerprint(
                        qvariables['params'])},
        'calib': {'source': source, 'samples': int(images.shape[0]),
                  'seed': int(seed),
                  'indices': [int(i) for i in indices or []],
                  'hash': calibration_hash(images, masks, seed, indices)},
        'activations': act,
        'agreement_frac': agreement,
        'miou': miou,
        'gate': {'max_drop': float(max_drop),
                 'passed': bool(miou['drop'] <= max_drop)},
    }
    return record


def record_to_json(record: QuantRecord) -> str:
    """The one canonical serialization: sorted keys, indent 1, trailing
    newline."""
    return json.dumps(record, sort_keys=True, indent=1) + '\n'
