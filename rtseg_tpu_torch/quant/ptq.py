"""Per-channel symmetric int8 post-training quantization (counterpart of
rtseg_tpu/quant/ptq.py).

The quantized representation is the Flax-shaped variables tree that
utils/convert.py gives (`to_jax_variables`), with each quantizable leaf
(float arrays with >= 2 dims: conv kernels and Dense matrices) swapped for
a small dict ``{'kind': QKIND, 'q': int8, 'scale': f32}`` with one scale a
channel of the Flax kernel's *last* axis, the JAX package's rule. 1-D
leaves (biases, BN scale/bias/mean/var) stay f32. Working on the Flax
tree, not on the torch tensors, keeps the JAX package's leaf order (the
sorted tree-flatten), its axis rule (a torch `ConvTranspose2d` weight
holds its channels otherwise) and the draw order of `corrupt_scales`, so
that both packages give the same bytes.

The inference function (:func:`build_quantized_inference_fn`) carries the
int8 tensors and the f32 scales as buffers, moved into the torch layout by
the converter's rule for each module type, and dequantizes them *inside
the traced forward* (`torch.func.functional_call`), so that `torch.export`
stores int8 constants and the artifact shrinks against the f32 one. Every
int8 -> float conversion of a quantized forward lives in this package.

:func:`corrupt_scales` is the rollout drill's knob: seeded multiplicative
noise on the scale vectors after calibration.
"""

from __future__ import annotations

import copy
import hashlib
from typing import Any, Callable, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

#: marker for a quantized leaf dict inside a params tree
QKIND = 'segquant.int8'
#: symmetric int8 range; -128 is never produced (symmetric grid)
QMAX = 127.0


def is_qleaf(x: Any) -> bool:
    return isinstance(x, Mapping) and x.get('kind') == QKIND


def _leaves(tree, is_leaf: Callable[[Any], bool] = lambda x: False,
            path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in the order of JAX's tree-flatten of nested dicts:
    keys sorted at every level."""
    if isinstance(tree, Mapping) and not is_leaf(tree):
        for k in sorted(tree):
            yield from _leaves(tree[k], is_leaf, path + (k,))
    else:
        yield path, tree


def _map(tree, fn: Callable, is_leaf: Callable[[Any], bool] = lambda x: False):
    """`tree` with every leaf (per `is_leaf`) replaced by fn(leaf), the
    leaves visited in `_leaves` order."""
    if isinstance(tree, Mapping) and not is_leaf(tree):
        return {k: _map(tree[k], fn, is_leaf) for k in sorted(tree)}
    return fn(tree)


def _quantizable(arr: np.ndarray) -> bool:
    return arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating)


def _quantize(leaf):
    arr = np.asarray(leaf)
    if not _quantizable(arr):
        return arr
    flat = arr.reshape(-1, arr.shape[-1]).astype(np.float32)
    maxabs = np.max(np.abs(flat), axis=0)
    scale = np.where(maxabs > 0.0, maxabs / np.float32(QMAX),
                     np.ones_like(maxabs)).astype(np.float32)
    q = np.clip(np.round(arr.astype(np.float32) / scale),
                -QMAX, QMAX).astype(np.int8)
    return {'kind': QKIND, 'q': q, 'scale': scale}


def quantize_params(params) -> Any:
    """Params tree -> quantized tree (the same nesting; quantizable leaves
    become qleaf dicts, everything else passes through as f32).

    Per-channel symmetric: scale[c] = maxabs over all other axes / 127,
    taken on the *last* axis of the Flax leaf. An all-zero channel gets
    scale 1.0 so the dequant never multiplies with 0.
    """
    return _map(params, _quantize)


def quantize_variables(variables) -> Dict[str, Any]:
    """Quantize ``variables['params']``; batch_stats (and any other
    collection) pass through untouched."""
    return dict(variables, params=quantize_params(variables['params']))


def dequantize_params(qparams) -> Any:
    """Quantized tree -> f32 tree, on the host (numpy)."""
    def deq(x):
        if is_qleaf(x):
            return np.asarray(x['q']).astype(np.float32) * np.asarray(
                x['scale'], np.float32)
        return x
    return _map(qparams, deq, is_qleaf)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 weights times their f32 scales: the dequant site of a traced
    quantized forward, one a quantized leaf."""
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize (QDQ) one activation tensor with a per-tensor
    scale (a 0-d f32 tensor on x's device): the activation-quantization
    boundary. Round-trips through a real int8 tensor, so the traced
    program carries the exact serving quantization error."""
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return q.to(torch.float32) * scale


def _torch_sites(model: torch.nn.Module, qparams) -> List[tuple]:
    """(module name, tensor name, q, scale) of every quantized leaf, each
    moved into the torch layout by utils/convert.py's rule for its
    module's type: q transposed as the kernel is, the scale shaped to
    broadcast along the axis that the Flax kernel's last axis goes to."""
    from ..utils.convert import _module_types, _rule, _rules
    types = _module_types(model)
    sites = []
    for path, leaf in _leaves(qparams, is_qleaf):
        if not is_qleaf(leaf):
            continue
        scope, name = '.'.join(path[:-1]), path[-1]
        rule = _rule(types, scope, _rules(), f'quantized leaf '
                     f'{"/".join(path)}')
        if ('params', name) not in rule:
            raise KeyError(f'quantized leaf {"/".join(path)}: a '
                           f'{types[scope].__name__} has no such leaf')
        tensor, order = rule[('params', name)]
        q = np.asarray(leaf['q'])
        if order is None or q.ndim != len(order):
            raise ValueError(f'quantized leaf {"/".join(path)}: a '
                             f'{q.ndim}-D leaf of a {types[scope].__name__}')
        shape = [1] * q.ndim
        shape[order.index(q.ndim - 1)] = q.shape[-1]
        sites.append((scope, tensor,
                      torch.from_numpy(np.ascontiguousarray(
                          q.transpose(order))),
                      torch.from_numpy(np.asarray(
                          leaf['scale'], np.float32).reshape(shape))))
    return sites


class QuantizedInference(torch.nn.Module):
    """The quantized counterpart of export.build_inference_fn, as a module
    (`torch.export` takes it as it is): the model's quantized weights are
    int8 buffers (`<tensor>_q`) and f32 scales (`<tensor>_scale`) on the
    modules that use them, and the float weights are gone; the forward
    dequantizes them and runs the model with them
    (`torch.func.functional_call`). The head is the same: float32 logits,
    or with ``argmax`` the channel argmax as int8."""

    def __init__(self, model: torch.nn.Module, qvariables,
                 compute_dtype=None, argmax: bool = True,
                 input_scale=None):
        super().__init__()
        from ..train.step import dtype_named
        from ..utils.convert import load_jax_variables
        if model.training:
            raise ValueError('build_quantized_inference_fn needs the model '
                             'in eval mode')
        net = copy.deepcopy(model)
        device = next(net.parameters()).device
        load_jax_variables(net, dict(
            qvariables, params=dequantize_params(qvariables['params'])))
        self.sites = []
        for scope, tensor, q, scale in _torch_sites(net, qvariables['params']):
            module = net.get_submodule(scope)
            del module._parameters[tensor]
            module.register_buffer(f'{tensor}_q', q.to(device))
            module.register_buffer(f'{tensor}_scale', scale.to(device))
            self.sites.append((scope, tensor))
        self.net = net
        self.dtype = dtype_named(compute_dtype)
        self.argmax = argmax
        self.register_buffer(
            'input_scale', None if input_scale is None else torch.tensor(
                float(input_scale), dtype=torch.float32, device=device))

    def weights(self) -> Dict[str, torch.Tensor]:
        """The dequantized weights, keyed by their names in `self.net`."""
        out = {}
        for scope, tensor in self.sites:
            module = self.net.get_submodule(scope)
            out[f'{scope}.{tensor}'] = dequantize(
                getattr(module, f'{tensor}_q'),
                getattr(module, f'{tensor}_scale'))
        return out

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.input_scale is not None:
            images = fake_quant(images, self.input_scale)
        logits = torch.func.functional_call(
            self.net, self.weights(), (images.to(self.dtype),),
            {'defer_upsample': False}, strict=False).float()
        if self.argmax:
            return torch.argmax(logits, dim=-1).to(torch.int8)
        return logits


def build_quantized_inference_fn(model: torch.nn.Module, qvariables,
                                 compute_dtype=None, argmax: bool = True,
                                 input_scale=None) -> QuantizedInference:
    """fn(images f32[B, H, W, 3]) -> int8[B, H, W] masks (``argmax``) or
    float32 logits, the weights dequantized in the forward from the qleaf
    tree `qvariables` (a Flax-shaped tree, `quantize_variables`).
    ``model`` (in eval mode, on the device to run on) gives the
    architecture and is not changed. ``input_scale`` (from calibration,
    ``activations``) adds a QDQ on the input boundary."""
    return QuantizedInference(model, qvariables, compute_dtype, argmax,
                              input_scale)


def corrupt_scales(qvariables, amount: float, seed: int = 0
                   ) -> Dict[str, Any]:
    """Seeded multiplicative noise on every scale vector: scale *=
    (1 + amount * N(0, 1)), the qleaves drawn in tree-flatten order.
    Applied after calibration on purpose: the bake-time quality gate has
    already passed, so the regression is only visible to the live
    planes."""
    rng = np.random.default_rng(seed)

    def corrupt(leaf):
        if not is_qleaf(leaf):
            return leaf
        scale = np.asarray(leaf['scale'])
        noise = rng.standard_normal(scale.shape).astype(np.float32)
        return dict(leaf, scale=scale * (1.0 + amount * noise))
    return dict(qvariables,
                params=_map(qvariables['params'], corrupt, is_qleaf))


def quantized_nbytes(qparams) -> Dict[str, int]:
    """Byte accounting over one quantized tree: {'int8': payload bytes
    as stored (q + scales + passthrough f32 leaves), 'f32': what the
    same tree costs unquantized, 'quantized_leaves': n, 'total_leaves':
    m}."""
    int8 = f32 = nq = total = 0
    for _, leaf in _leaves(qparams, is_qleaf):
        total += 1
        if is_qleaf(leaf):
            q, scale = np.asarray(leaf['q']), np.asarray(leaf['scale'])
            int8 += q.nbytes + scale.nbytes
            f32 += q.size * 4
            nq += 1
        else:
            arr = np.asarray(leaf)
            int8 += arr.nbytes
            f32 += arr.nbytes
    return {'int8': int8, 'f32': f32, 'quantized_leaves': nq,
            'total_leaves': total}


def scale_fingerprint(qparams) -> str:
    """sha256 over every scale vector (tree-flatten order, raw f32
    bytes): same weights + same quantizer give the same fingerprint."""
    h = hashlib.sha256()
    for _, leaf in _leaves(qparams, is_qleaf):
        if is_qleaf(leaf):
            h.update(np.ascontiguousarray(
                np.asarray(leaf['scale'], np.float32)).tobytes())
    return h.hexdigest()
