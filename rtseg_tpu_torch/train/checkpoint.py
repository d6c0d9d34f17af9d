"""Checkpoint and resume (counterpart of rtseg_tpu/train/checkpoint.py),
with torch.save, written off the epoch loop by `AsyncCkptWriter`.

Reference semantics (core/base_trainer.py:126-163), as in the JAX package:
  * last.ckpt: every epoch, the full train state (step, weights and BN
    statistics, the optimizer's state, EMA) and {cur_epoch, best_score};
    a restart resumes from it, since load_ckpt_path defaults to
    save_dir/last.ckpt.
  * best.ckpt: when the val mIoU improves, the EMA weights only.

Each checkpoint is a directory holding the JAX package's `meta.json`
(`kind`, `cur_epoch`, `best_score`; a train checkpoint also `optimizer`,
the config.optimizer_type that wrote it) and one `state.pt`. Weights and
the optimizer's buffers are stored as nested dicts of CPU tensors under
their Flax paths (utils/convert.py), the layout of the JAX package's
trees: SGD's `momentum`; Adam's and AdamW's `exp_avg` and `exp_avg_sq`
with their update count `adam_step`. A train checkpoint resumes only
under the optimizer that wrote it. `save_weights_ckpt` writes the "best"
format (the EMA weights of `write_best_ckpt`, and the reference `.pth`
import of tools/torch_import_reference.py); `from_orbax_tree` maps a JAX
checkpoint's restored tree into this layout (tools/orbax_to_torch.py, the
one bridge that needs both installations).

A write takes a snapshot first (`snapshot_state`): a device-side copy of
the tensors, queued on the current stream, which the next train step
cannot touch though it updates the weights in place (the JAX package's
compiled step donates them). The writer thread moves the copy to the host
and writes it.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.convert import (from_jax_variables, load_jax_variables,
                             state_dict_to_flax)
from .optim import optimizer_type
from .state import TrainState

_META = 'meta.json'
_STATE = 'state.pt'
# the optimizer's per-parameter buffers a train checkpoint holds
_BUFFERS = {'sgd': {'momentum': 'momentum_buffer'},
            'adam': {'exp_avg': 'exp_avg', 'exp_avg_sq': 'exp_avg_sq'}}
_BUFFERS['adamw'] = _BUFFERS['adam']


class AsyncCkptWriter:
    """One-deep background checkpoint writer (the JAX package's contract).

    `submit(fn)` first joins any write still in flight (saves stay ordered
    on disk and at most one snapshot is resident), then runs `fn` on a
    daemon thread. A failed write raises on the next `submit` or `join`,
    so the epoch loop hears of a bad disk at the next save. `join()` runs
    before anything reads a checkpoint (resume, val_best) and at the end
    of `run()`. The thread handle and the captured error are guarded by a
    lock; `join` and `close` are idempotent and never join the writer
    thread from itself; submitters are serialized."""

    def __init__(self):
        self._submit_lock = threading.Lock()   # serializes submitters
        self._lock = threading.Lock()          # guards _thread and _err
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        with self._submit_lock:
            self.join()

            def run():
                try:
                    fn()
                except BaseException as e:   # noqa: BLE001 - raised on join
                    with self._lock:
                        self._err = e

            t = threading.Thread(target=run, name='ckpt-writer', daemon=True)
            with self._lock:
                self._thread = t
            t.start()

    def join(self) -> None:
        with self._lock:
            t = self._thread
        # outside the lock: the writer takes it to record its error
        if t is not None and t is not threading.current_thread():
            t.join()
        with self._lock:
            if self._thread is t:
                self._thread = None
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError('background checkpoint write failed') from err

    def close(self) -> None:
        """`join()` under the name of the teardown paths: a failed write
        still raises."""
        self.join()


def _clone(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


def snapshot_state(state: TrainState, weights_only: bool = False) -> dict:
    """A device-side copy of what a checkpoint of `state` holds, queued on
    the current stream: {'ready': an event after the copies (CUDA) or
    None, 'model': the module that names the tensors, 'ema_variables',
    and unless `weights_only` 'step', 'optimizer', 'variables' and the
    optimizer's buffers by parameter name}."""
    snap = {'model': state.model,
            'ema_variables': _clone(state.ema_model.state_dict())}
    if not weights_only:
        kind = optimizer_type(state.optimizer)
        names = {p: n for n, p in state.model.named_parameters()}
        opt = state.optimizer.state
        snap.update(step=int(state.step), optimizer=kind,
                    variables=_clone(state.model.state_dict()))
        for key, buf in _BUFFERS[kind].items():
            snap[key] = _clone({names[p]: s[buf] for p, s in opt.items()
                                if s.get(buf) is not None})
        if kind != 'sgd':
            # every parameter is updated every step (train/step.py), so
            # all share one count
            snap['adam_step'] = int(next(iter(opt.values()))['step']) \
                if opt else 0
    snap['ready'] = None
    if next(state.model.parameters()).device.type == 'cuda':
        snap['ready'] = torch.cuda.Event()
        snap['ready'].record()
    return snap


def _as_tensors(tree: Mapping) -> dict:
    return {k: _as_tensors(v) if isinstance(v, Mapping)
            else v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _flax(sd: Mapping[str, torch.Tensor], model: torch.nn.Module) -> dict:
    return _as_tensors(state_dict_to_flax(sd, model))


def write_checkpoint(path: str, payload: dict, meta: dict) -> None:
    """Write `payload` (state.pt) and `meta` (meta.json) into the
    directory `path`."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    with open(os.path.join(path, _META), 'w') as f:
        json.dump(meta, f)


def write_train_ckpt(path: str, snap: dict, cur_epoch: int,
                     best_score: float) -> None:
    """Write last.ckpt from a `snapshot_state` (any thread)."""
    if snap['ready'] is not None:
        snap['ready'].synchronize()
    model, kind = snap['model'], snap['optimizer']
    payload = {'step': snap['step'],
               'variables': _flax(snap['variables'], model),
               'ema_variables': _flax(snap['ema_variables'], model)}
    for key in _BUFFERS[kind]:
        payload[key] = _flax(snap[key], model)
    if kind != 'sgd':
        payload['adam_step'] = snap['adam_step']
    write_checkpoint(path, payload, {'cur_epoch': cur_epoch,
                           'best_score': float(best_score), 'kind': 'train',
                           'optimizer': kind})


def write_best_ckpt(path: str, snap: dict, cur_epoch: int,
                    best_score: float) -> None:
    """Write best.ckpt, the EMA weights only (reference
    base_trainer.py:155,161-162), from a `snapshot_state` (any thread)."""
    if snap['ready'] is not None:
        snap['ready'].synchronize()
    save_weights_ckpt(path, _flax(snap['ema_variables'], snap['model']),
                      cur_epoch=cur_epoch, best_score=float(best_score))


def save_weights_ckpt(path: str, variables: Mapping, **meta) -> None:
    """A weights-only ("best") checkpoint of Flax-path `variables`
    ({'params', 'batch_stats'}, numpy arrays or tensors) with `meta` in
    its meta.json beside kind 'best' (the counterpart of
    rtseg_tpu/train/checkpoint.py:save_weights_ckpt)."""
    write_checkpoint(path, {'variables': _as_tensors(variables)},
                     {'kind': 'best', **meta})


def save_train_ckpt(path: str, state: TrainState, cur_epoch: int,
                    best_score: float) -> None:
    write_train_ckpt(path, snapshot_state(state), cur_epoch, best_score)


def save_best_ckpt(path: str, state: TrainState, cur_epoch: int,
                   best_score: float) -> None:
    write_best_ckpt(path, snapshot_state(state, weights_only=True),
                    cur_epoch, best_score)


def load_meta(path: str) -> Optional[Dict[str, Any]]:
    meta_path = os.path.join(os.path.abspath(path), _META)
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)


def _read(path: str) -> dict:
    file = os.path.join(os.path.abspath(path), _STATE)
    if not os.path.exists(file):
        raise FileNotFoundError(
            f'{path} has a {_META} but no {_STATE}: it is not a checkpoint '
            f'of the PyTorch port. A JAX package checkpoint (orbax) is read '
            f'on a machine with orbax installed: convert it with '
            f'`python tools/orbax_to_torch.py --src {path} --dst OUT '
            f'--optimizer_type ...` and load OUT')
    return torch.load(file, map_location='cpu', weights_only=True)


def restore_train_ckpt(path: str, state: TrainState) -> Tuple[int, float]:
    """Full resume into `state` (step, weights, the optimizer's buffers,
    EMA); returns (cur_epoch, best_score). The checkpoint's optimizer must
    be `state`'s."""
    meta = load_meta(path) or {'cur_epoch': 0, 'best_score': 0.0}
    kind = optimizer_type(state.optimizer)
    saved = meta.get('optimizer', 'sgd')    # earlier port checkpoints: SGD
    if saved != kind:
        raise ValueError(f'{path} holds the state of optimizer {saved!r}; '
                         f'this run trains with {kind!r}: resume it with '
                         f'optimizer_type={saved!r} or start afresh')
    payload = _read(path)
    load_jax_variables(state.model, payload['variables'])
    load_jax_variables(state.ema_model, payload['ema_variables'])
    opt = state.optimizer.state
    for key, buf in _BUFFERS[kind].items():
        buffers = from_jax_variables(payload[key], state.model)
        for name, p in state.model.named_parameters():
            if name in buffers:
                opt[p][buf] = buffers[name].to(p.device)
    if kind != 'sgd':
        # torch's Adam keeps its count as a float32 CPU scalar a parameter
        # (not capturable)
        for p in state.model.parameters():
            if p in opt:
                opt[p]['step'] = torch.tensor(float(payload['adam_step']),
                                              dtype=torch.float32)
    state.step = int(payload['step'])
    return int(meta['cur_epoch']), float(meta['best_score'])


def restore_weights(path: str, model: torch.nn.Module) -> None:
    """Weights-only load of any checkpoint into `model`."""
    load_jax_variables(model, _read(path)['variables'])


# --------------------------------------------------- the JAX package's trees

def _find(tree, want) -> list:
    """Every dict in `tree` (nested dicts and lists, as orbax restores a
    tree without a template) that holds all the keys of `want`."""
    found = []
    if isinstance(tree, Mapping):
        if all(k in tree for k in want):
            found.append(tree)
        for v in tree.values():
            found += _find(v, want)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            found += _find(v, want)
    return found


def _jax_optimizer(opt_state) -> str:
    """'sgd', 'adam' or 'adamw' from the structure of an optax state of
    rtseg_tpu/train/optim.py:get_optimizer: SGD's chain holds a `trace`;
    Adam and AdamW a `mu`/`nu` pair, AdamW with a `weight_decay`
    hyperparameter under inject_hyperparams (OneCycle) or a third chain
    element (add_decayed_weights) without it."""
    if _find(opt_state, ('trace',)):
        return 'sgd'
    if not _find(opt_state, ('mu', 'nu')):
        raise ValueError('the checkpoint\'s opt_state holds neither an SGD '
                         'trace nor Adam moments')
    hyper = _find(opt_state, ('hyperparams', 'inner_state'))
    if hyper:
        return 'adamw' if 'weight_decay' in hyper[0]['hyperparams'] \
            else 'adam'
    chain = opt_state if isinstance(opt_state, (list, tuple)) else []
    return 'adamw' if len(chain) == 3 else 'adam'


def _variables(tree, prefix: str = '') -> dict:
    return {'params': tree[prefix + 'params'],
            'batch_stats': tree.get(prefix + 'batch_stats') or {}}


def from_orbax_tree(tree: Mapping, meta: Optional[Mapping],
                    optimizer_type: Optional[str]) -> Tuple[dict, dict]:
    """(payload, meta) of this package's checkpoint from the tree of a JAX
    package checkpoint (rtseg_tpu/train/checkpoint.py) restored by orbax
    without a template, and its meta.json. numpy and torch only.

    A train checkpoint ("last"): params/batch_stats -> variables, ema_* ->
    ema_variables, step; SGD's optax `trace` -> momentum; Adam's and
    AdamW's `mu`/`nu`/`count` -> exp_avg/exp_avg_sq/adam_step (through
    the inject_hyperparams wrapper of OneCycle runs). The optimizer is read
    from the tree's structure and must be `optimizer_type`. meta.json is
    copied with `optimizer` added. A weights checkpoint ("best", or the
    JAX reference import) maps its weights alone."""
    meta = dict(meta or {})
    if meta.get('kind', 'train') != 'train' or 'opt_state' not in tree:
        return {'variables': _as_tensors(_variables(tree))}, meta
    found = _jax_optimizer(tree['opt_state'])
    if optimizer_type is None:
        raise ValueError(f'a train checkpoint holds optimizer state: name '
                         f'its optimizer_type (this one holds {found!r})')
    if found != optimizer_type:
        raise ValueError(f'the checkpoint holds the state of optimizer '
                         f'{found!r}, not {optimizer_type!r}')
    payload = {'step': int(np.asarray(tree['step'])),
               'variables': _as_tensors(_variables(tree)),
               'ema_variables': _as_tensors(_variables(tree, 'ema_'))}
    if found == 'sgd':
        payload['momentum'] = _as_tensors(
            {'params': _find(tree['opt_state'], ('trace',))[0]['trace']})
    else:
        adam = _find(tree['opt_state'], ('mu', 'nu', 'count'))[0]
        payload['exp_avg'] = _as_tensors({'params': adam['mu']})
        payload['exp_avg_sq'] = _as_tensors({'params': adam['nu']})
        payload['adam_step'] = int(np.asarray(adam['count']))
    meta['optimizer'] = found
    return payload, meta
