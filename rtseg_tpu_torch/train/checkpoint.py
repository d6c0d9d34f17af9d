"""Checkpoint and resume (counterpart of rtseg_tpu/train/checkpoint.py),
written synchronously with torch.save.

Reference semantics (core/base_trainer.py:126-163), as in the JAX package:
  * last.ckpt: every epoch, the full train state (step, weights and BN
    statistics, SGD momentum buffers, EMA) and {cur_epoch, best_score};
    a restart resumes from it, since load_ckpt_path defaults to
    save_dir/last.ckpt.
  * best.ckpt: when the val mIoU improves, the EMA weights only.

Each checkpoint is a directory holding the JAX package's `meta.json`
(`kind`, `cur_epoch`, `best_score`) and one `state.pt`. Weights and
momentum buffers are stored as nested dicts of CPU tensors under their
Flax paths (utils/convert.py), the layout of the JAX package's trees.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.convert import (from_jax_variables, load_jax_variables,
                             state_dict_to_flax, to_jax_variables)
from .state import TrainState

_META = 'meta.json'
_STATE = 'state.pt'


def _as_tensors(tree: Mapping) -> dict:
    return {k: _as_tensors(v) if isinstance(v, Mapping)
            else torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _write(path: str, payload: dict, meta: dict) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    with open(os.path.join(path, _META), 'w') as f:
        json.dump(meta, f)


def _read(path: str) -> dict:
    file = os.path.join(os.path.abspath(path), _STATE)
    if not os.path.exists(file):
        raise FileNotFoundError(
            f'{path} has a {_META} but no {_STATE}: it is not a checkpoint '
            f'of the PyTorch port (reading the JAX package\'s orbax '
            f'checkpoints is queued, ROADMAP.md Queue 1, "Trainer, checkpoint '
            f'and data")')
    return torch.load(file, map_location='cpu', weights_only=True)


def save_train_ckpt(path: str, state: TrainState, cur_epoch: int,
                    best_score: float) -> None:
    names = {p: n for n, p in state.model.named_parameters()}
    momentum = {names[p]: s['momentum_buffer']
                for p, s in state.optimizer.state.items()
                if s.get('momentum_buffer') is not None}
    payload = {
        'step': int(state.step),
        'variables': _as_tensors(to_jax_variables(state.model)),
        'ema_variables': _as_tensors(to_jax_variables(state.ema_model)),
        'momentum': _as_tensors(state_dict_to_flax(momentum, state.model)),
    }
    _write(path, payload, {'cur_epoch': cur_epoch,
                           'best_score': float(best_score), 'kind': 'train'})


def save_best_ckpt(path: str, state: TrainState, cur_epoch: int,
                   best_score: float) -> None:
    """EMA weights only (reference base_trainer.py:155,161-162)."""
    _write(path, {'variables': _as_tensors(to_jax_variables(state.ema_model))},
           {'cur_epoch': cur_epoch, 'best_score': float(best_score),
            'kind': 'best'})


def load_meta(path: str) -> Optional[Dict[str, Any]]:
    meta_path = os.path.join(os.path.abspath(path), _META)
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)


def restore_train_ckpt(path: str, state: TrainState) -> Tuple[int, float]:
    """Full resume into `state` (step, weights, momentum buffers, EMA);
    returns (cur_epoch, best_score)."""
    payload = _read(path)
    load_jax_variables(state.model, payload['variables'])
    load_jax_variables(state.ema_model, payload['ema_variables'])
    buffers = from_jax_variables(payload['momentum'], state.model)
    for name, p in state.model.named_parameters():
        if name in buffers:
            state.optimizer.state[p]['momentum_buffer'] = \
                buffers[name].to(p.device)
    state.step = int(payload['step'])
    meta = load_meta(path) or {'cur_epoch': 0, 'best_score': 0.0}
    return int(meta['cur_epoch']), float(meta['best_score'])


def restore_weights(path: str, model: torch.nn.Module) -> None:
    """Weights-only load of any checkpoint into `model`."""
    load_jax_variables(model, _read(path)['variables'])
