"""Offline import of a torchvision backbone (the counterpart of
rtseg_tpu/utils/torch_import.py).

The reference gets its ImageNet backbones by letting torchvision download
them when a model is built. Here, as in the JAX package, the import is an
explicit offline step: `config.backbone_ckpt` names a local torchvision
`state_dict` (.pth; a checkpoint that wraps it under 'state_dict' is
unwrapped), and it is mapped onto the Flax-path variables of the model's
`backbone`, `frontend` or `encoder` scope (models/backbone.py: ResNet,
Mobilenetv2). Tensors the backbone does not hold (ResNet's `fc`,
MobileNetV2's `features.18` and `classifier`, BatchNorm's
`num_batches_tracked`) are not read.

Layouts: a conv's torch (out, in/g, kh, kw) becomes Flax (kh, kw, in/g,
out); BatchNorm's weight and bias become params scale and bias, its
running_mean and running_var batch_stats mean and var. Every value is
checked against the shape of the leaf it replaces.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.backbone import RESNET_LAYERS
from .convert import load_jax_variables, to_jax_variables

BACKBONE_SCOPES = ('backbone', 'frontend', 'encoder')


def _t2f_conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if 'state_dict' in sd:
        sd = sd['state_dict']
    return {k: v.numpy() for k, v in sd.items()}


def _copy(tree: Mapping) -> dict:
    return {k: _copy(v) if isinstance(v, Mapping) else np.array(v)
            for k, v in tree.items()}


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    cur = node[path[-1]]
    if tuple(cur.shape) != tuple(value.shape):
        raise ValueError(f'{"/".join(path)}: {cur.shape} != {value.shape}')
    node[path[-1]] = value.astype(cur.dtype)


def _bn(sd, params, batch_stats, torch_prefix: str,
        path: Tuple[str, ...]) -> None:
    _set(params, path + ('bn', 'scale'), sd[f'{torch_prefix}.weight'])
    _set(params, path + ('bn', 'bias'), sd[f'{torch_prefix}.bias'])
    _set(batch_stats, path + ('bn', 'mean'),
         sd[f'{torch_prefix}.running_mean'])
    _set(batch_stats, path + ('bn', 'var'), sd[f'{torch_prefix}.running_var'])


def _conv(sd, params, torch_name: str, path: Tuple[str, ...]) -> None:
    _set(params, path + ('conv', 'kernel'), _t2f_conv(sd[torch_name]))


def import_resnet(sd: Mapping[str, np.ndarray], params: Mapping,
                  batch_stats: Mapping, layers_per_stage
                  ) -> Tuple[dict, dict]:
    """A torchvision ResNet state_dict onto models.backbone.ResNet's Flax
    variables (copies; the inputs are not changed)."""
    params, batch_stats = _copy(params), _copy(batch_stats)
    _conv(sd, params, 'conv1.weight', ('conv1',))
    _bn(sd, params, batch_stats, 'bn1', ('bn1',))
    for i, n_blocks in enumerate(layers_per_stage):
        for j in range(n_blocks):
            tp, fp = f'layer{i + 1}.{j}', f'layer{i + 1}_{j}'
            for cname in ('conv1', 'conv2', 'conv3'):
                if f'{tp}.{cname}.weight' not in sd:
                    continue
                bname = f'bn{cname[-1]}'
                _conv(sd, params, f'{tp}.{cname}.weight', (fp, cname))
                _bn(sd, params, batch_stats, f'{tp}.{bname}', (fp, bname))
            if f'{tp}.downsample.0.weight' in sd:
                _conv(sd, params, f'{tp}.downsample.0.weight',
                      (fp, 'downsample_conv'))
                _bn(sd, params, batch_stats, f'{tp}.downsample.1',
                    (fp, 'downsample_bn'))
    return params, batch_stats


def import_mobilenetv2(sd: Mapping[str, np.ndarray], params: Mapping,
                       batch_stats: Mapping) -> Tuple[dict, dict]:
    """torchvision mobilenet_v2's features[0:18] onto
    models.backbone.Mobilenetv2's Flax variables (copies)."""
    params, batch_stats = _copy(params), _copy(batch_stats)
    _conv(sd, params, 'features.0.0.weight', ('stem',))
    _bn(sd, params, batch_stats, 'features.0.1', ('stem_bn',))
    for idx in range(1, 18):
        tp, fname = f'features.{idx}.conv', f'block{idx}'
        if idx == 1:
            # the t=1 block: [dw ConvBNReLU, project conv, project bn]
            dw, proj = f'{tp}.0', f'{tp}.1'
            projbn = f'{tp}.2'
        else:
            dw, proj = f'{tp}.1', f'{tp}.2'
            projbn = f'{tp}.3'
            _conv(sd, params, f'{tp}.0.0.weight', (fname, 'expand'))
            _bn(sd, params, batch_stats, f'{tp}.0.1', (fname, 'expand_bn'))
        _conv(sd, params, f'{dw}.0.weight', (fname, 'dw'))
        _bn(sd, params, batch_stats, f'{dw}.1', (fname, 'dw_bn'))
        _conv(sd, params, f'{proj}.weight', (fname, 'project'))
        _bn(sd, params, batch_stats, projbn, (fname, 'project_bn'))
    return params, batch_stats


def load_torch_backbone(ckpt_path: str, backbone_type: str, params: Mapping,
                        batch_stats: Mapping) -> Tuple[dict, dict]:
    """A torchvision .pth onto the Flax variables of a backbone scope
    (`params` and `batch_stats` are that scope's subtrees)."""
    sd = load_torch_state_dict(ckpt_path)
    if backbone_type in RESNET_LAYERS:
        return import_resnet(sd, params, batch_stats,
                             RESNET_LAYERS[backbone_type][1])
    if backbone_type == 'mobilenet_v2':
        return import_mobilenetv2(sd, params, batch_stats)
    raise ValueError(f'Unsupported backbone type: {backbone_type}')


def import_backbone(model: torch.nn.Module, ckpt_path: str,
                    backbone_type: str) -> str:
    """Load a torchvision .pth into the model's first top-level scope of
    BACKBONE_SCOPES, as the JAX trainer does; the rest of the model keeps
    its weights. Returns the scope. A model without such a scope raises
    ValueError, a backbone_type that does not fit the model's backbone
    raises as the mapping meets the first missing or misshapen leaf."""
    variables = to_jax_variables(model)
    params = variables['params']
    batch_stats = variables.setdefault('batch_stats', {})
    scope = next((s for s in BACKBONE_SCOPES if s in params), None)
    if scope is None:
        raise ValueError(f'Model {type(model).__name__} has no backbone '
                         f'scope to load {ckpt_path} into.')
    params[scope], batch_stats[scope] = load_torch_backbone(
        ckpt_path, backbone_type, params[scope], batch_stats.get(scope, {}))
    load_jax_variables(model, variables)
    return scope
