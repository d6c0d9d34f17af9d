"""Weights between the JAX package's Flax variables and the port's modules.

The port's modules carry the Flax scope names, so a Flax leaf path maps to
a state_dict key mechanically:

  params/<scope...>/conv/kernel     -> <scope...>.conv.weight
                  HWIO (kh, kw, in/g, out) -> OIHW (out, in/g, kh, kw)
  params/<scope...>/conv/bias       -> <scope...>.conv.bias
  params/<scope...>/bn/scale        -> <scope...>.bn.weight
  params/<scope...>/bn/bias         -> <scope...>.bn.bias
  batch_stats/<scope...>/bn/mean    -> <scope...>.bn.running_mean
  batch_stats/<scope...>/bn/var     -> <scope...>.bn.running_var
  params/<scope...>/prelu/alpha     -> <scope...>.prelu.weight
  params/<scope...>/deconv/kernel   -> <scope...>.deconv.weight
          Flax ConvTranspose(transpose_kernel=True) (kh, kw, out, in)
          -> torch ConvTranspose2d (in, out, kh, kw)
  params/<scope...>/deconv/bias     -> <scope...>.deconv.bias
  params/<scope...>/ca_fc/kernel    -> <scope...>.ca_fc.weight
                  Dense (in, out) -> Linear (out, in)   (CANet's ca_fc)
  params/<scope...>/ca_fc/bias      -> <scope...>.ca_fc.bias

Variables are nested dicts of numpy arrays ({'params': ..., 'batch_stats':
...}), so no JAX is needed on either side. Loading is strict in both
directions: a Flax leaf without a rule, or a module tensor that no leaf
fills, raises. BatchNorm's `num_batches_tracked` counter has no Flax leaf
and is set to 0.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# (collection, module name, flax leaf) -> torch leaf
_TO_TORCH = {
    ('params', 'conv', 'kernel'): 'weight',
    ('params', 'conv', 'bias'): 'bias',
    ('params', 'bn', 'scale'): 'weight',
    ('params', 'bn', 'bias'): 'bias',
    ('batch_stats', 'bn', 'mean'): 'running_mean',
    ('batch_stats', 'bn', 'var'): 'running_var',
    ('params', 'prelu', 'alpha'): 'weight',
    ('params', 'deconv', 'kernel'): 'weight',
    ('params', 'deconv', 'bias'): 'bias',
    ('params', 'ca_fc', 'kernel'): 'weight',
    ('params', 'ca_fc', 'bias'): 'bias',
}
# module name -> (rank of its kernel, Flax -> torch axis order); the
# inverse order maps back. A conv's HWIO and a transposed conv's
# (kh, kw, out, in) both take (3, 2, 0, 1); each keeps its own rule
_KERNELS = {
    'conv': (4, (3, 2, 0, 1)),          # HWIO -> OIHW
    'deconv': (4, (3, 2, 0, 1)),        # (kh, kw, out, in) -> (in, out, kh, kw)
    'ca_fc': (2, (1, 0)),               # (in, out) -> (out, in)
}
_TO_FLAX = {(mod, t): (coll, f) for (coll, mod, f), t in _TO_TORCH.items()}
_TORCH_ONLY = 'num_batches_tracked'


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


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables -> the port's state_dict (CPU float32 tensors)."""
    sd = {}
    for path, v in _flatten(variables).items():
        if len(path) < 3:
            raise KeyError(f'unmapped Flax leaf {"/".join(path)}')
        coll, mod, leaf = path[0], path[-2], path[-1]
        rule = _TO_TORCH.get((coll, mod, leaf))
        if rule is None:
            raise KeyError(f'unmapped Flax leaf {"/".join(path)}')
        if leaf == 'kernel':
            rank, order = _KERNELS[mod]
            if v.ndim != rank:
                raise ValueError(f'{"/".join(path)}: expected a {rank}-D '
                                 f'{mod} kernel, got shape {v.shape}')
            v = v.transpose(order)
        key = '.'.join(path[1:-1] + (rule,))
        sd[key] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load Flax variables into `model`, strictly: every Flax leaf must map
    to a module tensor of the same shape and every module tensor must be
    filled."""
    sd = from_jax_variables(variables)
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
    return state_dict_to_flax(model.state_dict())


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Tensors keyed by the module's state_dict names (weights, or buffers
    shaped like them such as SGD momentum) as Flax variables, nested numpy
    dicts under the Flax paths of those names."""
    flat = {}
    for key, v in sd.items():
        parts = tuple(key.split('.'))
        if parts[-1] == _TORCH_ONLY:
            continue
        rule = _TO_FLAX.get((parts[-2], parts[-1]))
        if rule is None:
            raise KeyError(f'module tensor {key} has no Flax leaf')
        coll, leaf = rule
        a = v.detach().float().cpu().numpy()
        if leaf == 'kernel':
            a = a.transpose(np.argsort(_KERNELS[parts[-2]][1]))
        flat[(coll,) + parts[:-1] + (leaf,)] = np.ascontiguousarray(a)
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
