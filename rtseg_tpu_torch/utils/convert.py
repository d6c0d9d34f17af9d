"""Weights between the JAX package's Flax variables and the port's modules.

The port's modules carry the Flax scope names, so the scope of a Flax leaf
is the name of the torch module that holds its tensor (`named_modules()`),
and the rule that maps the leaf is keyed on that module's type alone:

  nn.Conv2d           params/kernel (kh, kw, in/g, out)
                          -> weight (out, in/g, kh, kw)
  nn.ConvTranspose2d  params/kernel (kh, kw, out, in) of Flax's
                      ConvTranspose(transpose_kernel=True)
                          -> weight (in, out, kh, kw)
  nn.Linear           params/kernel (in, out) of a Dense -> weight (out, in)
  those three         params/bias -> bias
  nn.BatchNorm2d      params/scale, params/bias -> weight, bias
                      batch_stats/mean, batch_stats/var
                          -> running_mean, running_var
  PReLU (nn/modules)  params/alpha -> weight
  nn.LayerNorm, GroupNorm (nn/modules)
                      params/scale, params/bias -> weight, bias

Variables are nested dicts of numpy arrays ({'params': ..., 'batch_stats':
...}), so no JAX is needed on either side. The functions that map a tree
take the model beside it, to read the module types from.
Mapping is strict in both directions: a Flax leaf whose scope names no
module, whose module has a type without a rule, or whose leaf name the
rule lacks raises; so does a kernel of another rank than its module's,
and a module tensor that no leaf fills. BatchNorm's `num_batches_tracked`
counter has no Flax leaf and is set to 0.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_CONV = {('params', 'kernel'): ('weight', (3, 2, 0, 1)),
         ('params', 'bias'): ('bias', None)}
_LINEAR = {('params', 'kernel'): ('weight', (1, 0)),
           ('params', 'bias'): ('bias', None)}
_NORM = {('params', 'scale'): ('weight', None),
         ('params', 'bias'): ('bias', None)}
_BN = {('params', 'scale'): ('weight', None),
       ('params', 'bias'): ('bias', None),
       ('batch_stats', 'mean'): ('running_mean', None),
       ('batch_stats', 'var'): ('running_var', None)}


@lru_cache(maxsize=None)
def _rules() -> Dict[type, dict]:
    """module type -> {(collection, Flax leaf): (torch tensor, Flax ->
    torch axis order of a kernel, whose length is its rank; the inverse
    order maps back)}. A conv's HWIO and a transposed conv's
    (kh, kw, out, in) both take (3, 2, 0, 1). Built at first use: the
    port's modules import the package that holds this converter."""
    from ..nn.modules import GroupNorm, PReLU
    return {nn.Conv2d: _CONV, nn.ConvTranspose2d: _CONV, nn.Linear: _LINEAR,
            nn.BatchNorm2d: _BN, nn.LayerNorm: _NORM, GroupNorm: _NORM,
            PReLU: {('params', 'alpha'): ('weight', None)}}


@lru_cache(maxsize=None)
def _to_flax() -> Dict[type, dict]:
    """module type -> {torch tensor: ((collection, Flax leaf), order)}."""
    return {t: {name: (key, order) for key, (name, order) in rule.items()}
            for t, rule in _rules().items()}


_TORCH_ONLY = 'num_batches_tracked'


def _module_types(model: nn.Module) -> Dict[str, type]:
    """The type of each module of `model`, keyed by its dotted name."""
    return {name: type(m) for name, m in model.named_modules()}


def _rule(types: Mapping[str, type], scope: str, table: dict, what: str):
    """The rule of the module named `scope`, or KeyError naming `what`."""
    if scope not in types:
        raise KeyError(f'{what}: no module named {scope!r}')
    rule = table.get(types[scope])
    if rule is None:
        raise KeyError(f'{what}: unknown module type '
                       f'{types[scope].__name__} at {scope!r}')
    return rule


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _nest(flat: Mapping[Tuple[str, ...], np.ndarray]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def from_jax_variables(variables: Mapping, model: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """Flax variables -> the state_dict of `model`, as CPU float32
    tensors."""
    types = _module_types(model)
    sd = {}
    for path, v in _flatten(variables).items():
        name = '/'.join(path)
        if len(path) < 3:
            raise KeyError(f'unmapped Flax leaf {name}')
        coll, scope, leaf = path[0], '.'.join(path[1:-1]), path[-1]
        rule = _rule(types, scope, _rules(), f'unmapped Flax leaf {name}')
        if (coll, leaf) not in rule:
            raise KeyError(f'unmapped Flax leaf {name}: a '
                           f'{types[scope].__name__} has no such leaf')
        tensor, order = rule[(coll, leaf)]
        if order is not None:
            if v.ndim != len(order):
                raise ValueError(f'{name}: expected a {len(order)}-D '
                                 f'{types[scope].__name__} kernel, got '
                                 f'shape {v.shape}')
            v = v.transpose(order)
        sd[f'{scope}.{tensor}'] = torch.from_numpy(
            np.ascontiguousarray(v, np.float32))
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load Flax variables into `model`, strictly: every Flax leaf must map
    to a module tensor of the same shape and every module tensor must be
    filled."""
    sd = from_jax_variables(variables, model)
    own = model.state_dict()
    for k, v in own.items():
        if k.endswith('.' + _TORCH_ONLY):
            sd[k] = torch.zeros_like(v)
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f'weights do not match the model: module tensors '
                       f'without a Flax leaf {missing[:8]}, Flax leaves '
                       f'without a module tensor {extra[:8]}')
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f'{k}: Flax leaf has shape {tuple(v.shape)}, '
                             f'the module {tuple(own[k].shape)}')
    model.load_state_dict(sd, strict=True)


def to_jax_variables(model: torch.nn.Module) -> dict:
    """The module's weights as Flax variables (nested numpy dicts)."""
    return state_dict_to_flax(model.state_dict(), model)


def state_dict_to_flax(sd: Mapping[str, torch.Tensor], model: nn.Module
                       ) -> dict:
    """Tensors keyed by `model`'s state_dict names (its weights, or
    buffers shaped like them such as SGD momentum) as Flax variables,
    nested numpy dicts under the Flax paths of those names."""
    types = _module_types(model)
    flat = {}
    for key, v in sd.items():
        scope, _, tensor = key.rpartition('.')
        if tensor == _TORCH_ONLY:
            continue
        rule = _rule(types, scope, _to_flax(),
                     f'module tensor {key} has no Flax leaf')
        if tensor not in rule:
            raise KeyError(f'module tensor {key} has no Flax leaf: a '
                           f'{types[scope].__name__} maps no {tensor!r}')
        (coll, leaf), order = rule[tensor]
        a = v.detach().float().cpu().numpy()
        if order is not None:
            if a.ndim != len(order):
                raise ValueError(f'{key}: expected a {len(order)}-D '
                                 f'{types[scope].__name__} weight, got '
                                 f'shape {a.shape}')
            a = a.transpose(np.argsort(order))
        flat[(coll,) + tuple(scope.split('.')) + (leaf,)] = \
            np.ascontiguousarray(a)
    return _nest(flat)


def random_jax_variables(model: torch.nn.Module, seed: int) -> dict:
    """Seeded random Flax variables shaped for `model`, made with numpy.

    Kernels are uniform(+-1/sqrt(n)), n the product of all their axes
    but the last (a conv's fan-in); biases, BatchNorm scales
    and running statistics get O(1) draws so that a swapped mapping cannot
    hide behind the 0/1 defaults."""
    rng = np.random.default_rng(seed)
    flat = _flatten(to_jax_variables(model))
    out = {}
    for path in sorted(flat):
        shape = flat[path].shape
        leaf = path[-1]
        if leaf == 'kernel':
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-bound, bound, shape)
        elif leaf == 'bias':
            a = rng.uniform(-0.2, 0.2, shape)
        elif leaf == 'mean':
            a = rng.uniform(-0.5, 0.5, shape)
        elif leaf == 'var':
            a = rng.uniform(0.5, 2.0, shape)
        else:                                    # BN scale, PReLU slope
            a = rng.uniform(0.5, 1.5, shape)
        out[path] = a.astype(np.float32)
    return _nest(out)


# Flax's lecun_normal: a normal truncated to [-2, 2], rescaled by the
# standard deviation of that truncation so that the draw has variance
# 1 / fan_in (jax.nn.initializers.variance_scaling, 'truncated_normal')
_TRUNC_STD = 0.87962566103423978
# the constant leaves of Flax's initializers: zero biases (conv, Dense and
# BatchNorm), BatchNorm scale 1 with running statistics 0 and 1, and the
# PReLU slope 0.25 (rtseg_tpu/nn/modules.py PReLU)
_FLAX_CONSTANTS = {'bias': 0.0, 'scale': 1.0, 'mean': 0.0, 'var': 1.0,
                   'alpha': 0.25}


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal values redrawn until all lie in [-2, 2]."""
    a = rng.standard_normal(shape)
    bad = np.abs(a) > 2.0
    while bad.any():
        a[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(a) > 2.0
    return a


def flax_init_variables(model: torch.nn.Module, seed: int) -> dict:
    """Flax variables shaped for `model`, drawn with numpy from `seed` by
    the initializers the JAX package's `model.init` uses: lecun-normal
    kernels (variance 1 / fan_in, fan_in the product of all axes of the
    Flax kernel but the last: a conv's kh*kw*in/groups, a transposed
    conv's kh*kw*out, a Dense layer's in) and the constants of
    `_FLAX_CONSTANTS`. A leaf of any other name raises: no initializer is
    guessed. The draws follow the sorted Flax paths, so a seed gives the
    same weights on every device."""
    rng = np.random.default_rng(seed)
    flat = _flatten(to_jax_variables(model))
    out = {}
    for path in sorted(flat):
        shape = flat[path].shape
        leaf = path[-1]
        if leaf == 'kernel':
            std = np.sqrt(1.0 / np.prod(shape[:-1])) / _TRUNC_STD
            a = _truncated_normal(rng, shape) * std
        elif leaf in _FLAX_CONSTANTS:
            a = np.full(shape, _FLAX_CONSTANTS[leaf])
        else:
            raise KeyError(f'no Flax initializer known for '
                           f'{"/".join(path)}')
        out[path] = a.astype(np.float32)
    return _nest(out)
