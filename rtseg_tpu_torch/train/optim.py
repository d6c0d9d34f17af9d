"""Optimizers and per-step LR / momentum schedules (counterpart of
rtseg_tpu/train/optim.py).

The schedules are plain functions of the 0-based update count k that
compute in float32, as the JAX package's do, so the port writes the same
LR and momentum (SGD) or beta1 (Adam, AdamW) into the param group before
update k. They follow torch OneCycleLR's piecewise anneal with its phase
boundaries at pct_start*T - 1 and T - 1, and its cycled momentum (0.95 ->
0.85 -> 0.95, inverse to the LR), which overrides config.momentum for the
OneCycle policies, as in the reference trainer.
torch.optim.lr_scheduler.OneCycleLR itself is not used: it computes in
float64, raises once stepped past total_steps where the JAX schedule
clamps, and rejects a pct_start above 1, which the JAX schedule
accepts.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], float]
_F = np.float32

# torch's Adam defaults, which the reference keeps, and the weight decay of
# each Adam kind (torch AdamW's default 1e-2)
ADAM_BETA2, ADAM_EPS = 0.999, 1e-8
ADAM_DECAY = {'adam': 0.0, 'adamw': 1e-2}


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


def get_momentum(config, torch_default: Optional[float] = None
                 ) -> Union[Schedule, float]:
    """SGD momentum or Adam's beta1: cycled 0.95 <-> 0.85 under the
    OneCycle policies; under 'step' config.momentum for SGD, and for Adam
    and AdamW `torch_default` (0.9), since the reference never forwards
    config.momentum to them."""
    if config.lr_policy == 'cos_warmup':
        return _onecycle_piecewise(config.total_itrs,
                                   config.warmup_epochs / config.total_epoch,
                                   'cos', 0.95, 0.85, 0.95)
    if config.lr_policy == 'linear':
        return _onecycle_piecewise(config.total_itrs, 0.0, 'linear',
                                   0.95, 0.85, 0.95)
    return config.momentum if torch_default is None else torch_default


def optimizer_momentum(config) -> Union[Schedule, float]:
    """The momentum (SGD) or beta1 (Adam, AdamW) that config's optimizer
    takes at each step."""
    return get_momentum(config, 0.9 if config.optimizer_type in ADAM_DECAY
                        else None)


def get_optimizer(config, params) -> torch.optim.Optimizer:
    """The update of the JAX package's optax chain for
    config.optimizer_type; `set_hparams` writes each step's LR and
    momentum (beta1) before the update.

    * sgd: torch SGD(momentum, weight_decay, dampening=0, nesterov=False),
      the chain add_decayed_weights -> trace -> scale_by_learning_rate.
    * adam: torch Adam with torch's defaults, as the reference builds it
      (lr only): beta2 0.999, eps 1e-8 outside the square root, no weight
      decay (config.weight_decay is unused, as in the reference), beta1
      0.9 cycled by OneCycle; the bias correction takes the current
      beta1 ** t, t from 1, as optax.scale_by_adam does.
    * adamw: the same with torch's decoupled decay of 1e-2 (optax's
      default is 1e-4): the old weight shrinks by lr * 1e-2.

    Adam and AdamW run torch's foreach path (one multi-tensor launch an
    operation on the card; the same float32 operations as the
    single-tensor path). The fused path is not used: it rounds otherwise
    on the card and on the CPU."""
    kind = config.optimizer_type
    if kind != 'sgd' and kind not in ADAM_DECAY:
        raise NotImplementedError(f'Unsupported optimizer type: {kind}')
    lr = get_lr_schedule(config)(0)
    mom = optimizer_momentum(config)
    mom = mom(0) if callable(mom) else mom
    if kind == 'sgd':
        return torch.optim.SGD(params, lr=lr, momentum=mom, dampening=0.0,
                               weight_decay=config.weight_decay,
                               nesterov=False)
    cls = torch.optim.Adam if kind == 'adam' else torch.optim.AdamW
    return cls(params, lr=lr, betas=(mom, ADAM_BETA2), eps=ADAM_EPS,
               weight_decay=ADAM_DECAY[kind], foreach=True, fused=False)


def optimizer_type(optimizer: torch.optim.Optimizer) -> str:
    """'sgd', 'adam' or 'adamw': the config.optimizer_type that built
    `optimizer`."""
    # AdamW is a subclass of Adam in recent torch: test it first
    for name, cls in (('adamw', torch.optim.AdamW), ('adam', torch.optim.Adam),
                      ('sgd', torch.optim.SGD)):
        if isinstance(optimizer, cls):
            return name
    raise TypeError(f'not an optimizer of the port: {type(optimizer)}')


def set_hparams(optimizer: torch.optim.Optimizer, lr: float,
                momentum: float) -> None:
    """Write the step's LR and momentum: SGD's `momentum`, or beta1 of
    Adam's `betas` (torch's Adam has no `momentum` key)."""
    for group in optimizer.param_groups:
        group['lr'] = lr
        if 'betas' in group:
            group['betas'] = (momentum, group['betas'][1])
        else:
            group['momentum'] = momentum
