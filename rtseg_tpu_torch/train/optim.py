"""Optimizer and per-step LR / momentum schedules (counterpart of
rtseg_tpu/train/optim.py).

The schedules are plain functions of the 0-based update count k that
compute in float32, as the JAX package's do, so the port writes the same
LR and momentum into the param group before update k. They follow torch
OneCycleLR's piecewise anneal with its phase boundaries at pct_start*T - 1
and T - 1, and its cycled momentum (0.95 -> 0.85 -> 0.95, inverse to the
LR), which overrides config.momentum for the OneCycle policies, as in the
reference trainer. torch.optim.lr_scheduler.OneCycleLR itself is not used:
it computes in float64, raises once stepped past total_steps where the JAX
schedule clamps, and rejects a pct_start above 1, which the JAX schedule
accepts.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

Schedule = Callable[[int], float]
_F = np.float32


def _onecycle_piecewise(total_steps: int, pct_start: float, anneal: str,
                        start1: float, mid: float, end2: float) -> Schedule:
    """torch OneCycleLR's piecewise anneal start1 -> mid -> end2."""
    e1 = _F(pct_start * total_steps - 1.0)
    e2 = _F(total_steps - 1)

    def cos(start, end, pct):
        # torch _annealing_cos
        return _F(end) + _F((start - end) / 2.0) * (
            _F(1.0) + np.cos(_F(np.pi) * pct))

    def lin(start, end, pct):
        return _F(start) + _F(end - start) * pct

    fn = cos if anneal == 'cos' else lin

    def schedule(count: int) -> float:
        c = _F(count)
        with np.errstate(divide='ignore', invalid='ignore'):
            if c <= e1:
                pct1 = c / max(e1, _F(1e-12)) if e1 > 0 else _F(1.0)
                return float(fn(start1, mid, np.clip(pct1, _F(0), _F(1))))
            pct2 = (c - e1) / max(e2 - e1, _F(1e-12))
            return float(fn(mid, end2, np.clip(pct2, _F(0), _F(1))))

    return schedule


def _torch_onecycle(total_steps: int, peak: float, pct_start: float,
                    anneal: str, div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> Schedule:
    initial = peak / div_factor
    return _onecycle_piecewise(total_steps, pct_start, anneal, initial, peak,
                               initial / final_div_factor)


def _exponential_decay(init: float, transition_steps: int, rate: float
                       ) -> Schedule:
    """Staircase decay init * rate ** floor(k / transition_steps)
    (optax.exponential_decay(staircase=True))."""
    def schedule(count: int) -> float:
        p = np.floor(_F(count) / _F(transition_steps))
        return float(_F(init) * np.power(_F(rate), p))
    return schedule


def get_lr_schedule(config) -> Schedule:
    assert config.total_itrs > 0, 'call config.resolve_schedule() first'
    if config.lr_policy == 'cos_warmup':
        return _torch_onecycle(config.total_itrs, config.lr,
                               config.warmup_epochs / config.total_epoch,
                               'cos')
    if config.lr_policy == 'linear':
        return _torch_onecycle(config.total_itrs, config.lr, 0.0, 'linear')
    if config.lr_policy == 'step':
        return _exponential_decay(config.lr, config.step_size,
                                  config.step_gamma)
    raise NotImplementedError(
        f'Unsupported scheduler type: {config.lr_policy}')


def get_momentum(config) -> Union[Schedule, float]:
    """SGD momentum: cycled 0.95 <-> 0.85 under the OneCycle policies,
    config.momentum under 'step'."""
    if config.lr_policy == 'cos_warmup':
        return _onecycle_piecewise(config.total_itrs,
                                   config.warmup_epochs / config.total_epoch,
                                   'cos', 0.95, 0.85, 0.95)
    if config.lr_policy == 'linear':
        return _onecycle_piecewise(config.total_itrs, 0.0, 'linear',
                                   0.95, 0.85, 0.95)
    return config.momentum


def get_optimizer(config, params) -> torch.optim.Optimizer:
    """torch SGD(momentum, weight_decay, dampening=0, nesterov=False): the
    update of the JAX package's optax chain add_decayed_weights -> trace ->
    scale_by_learning_rate. `set_hparams` writes each step's LR and
    momentum before the update."""
    if config.optimizer_type in ('adam', 'adamw'):
        raise NotImplementedError(
            f'optimizer {config.optimizer_type!r} is not ported to PyTorch '
            f'yet (ported: sgd); see ROADMAP.md Queue 1, "Optimizer tail"')
    if config.optimizer_type != 'sgd':
        raise NotImplementedError(
            f'Unsupported optimizer type: {config.optimizer_type}')
    mom = get_momentum(config)
    return torch.optim.SGD(params, lr=get_lr_schedule(config)(0),
                           momentum=mom(0) if callable(mom) else mom,
                           dampening=0.0, weight_decay=config.weight_decay,
                           nesterov=False)


def set_hparams(optimizer: torch.optim.Optimizer, lr: float,
                momentum: float) -> None:
    for group in optimizer.param_groups:
        group['lr'] = lr
        group['momentum'] = momentum
