"""Torch -> Flax-path weight transplant (counterpart of
rtseg_tpu/utils/transplant.py): the reference `.pth` import.

Both sides are reduced to an ordered list of leaf units (conv, deconv,
bn, dense, prelu, layernorm, groupnorm) and the lists are zipped.

  * `flax_leaf_order(model, x)`: the port's models carry the Flax scope
    names (utils/convert.py), so the Flax order is the order in which the
    port model's parameterized leaves are called, in one training forward
    of a copy of the model, as the JAX package's `model.init(..., True)`
    traces it. The port's wrappers (nn/modules.py `Conv`, `BatchNorm`,
    ...) run their leaf's tensors through functional calls rather than
    calling the leaf, so a leaf counts as called at the first torch call
    that takes one of its tensors (`_FirstUse`, a TorchFunctionMode): for
    a leaf that is called, that is inside its call, as the Flax
    interceptor records it at `__call__`. A leaf the forward never uses
    is one the Flax twin makes at init before anything else (STDC's
    `detail_conv`, which only the train step uses): such leaves come
    first. The variables returned beside the units are
    `flax_init_variables(model, seed)`, nested numpy dicts.
  * `torch_leaf_order(model, fwd)`: the same first use, over a live
    torch module (a reference model or the port's own);
    `sd_leaf_units(state_dict)`: registration (key) order, with
    `SD_REORDER`'s per-architecture fixups.

`apply_units` writes the torch arrays into a copy of the Flax-path numpy
tree; `utils/convert.py::load_jax_variables` then puts the tree into the
model, strictly both ways. Layouts:
  conv    torch (out, in/g, kh, kw)  -> flax (kh, kw, in/g, out)
  deconv  torch (in, out/g, kh, kw)  -> flax (kh, kw, out/g, in)
  dense   torch (out, in)            -> flax (in, out)
  bn      weight/bias -> scale/bias (params); running_mean/var ->
          batch_stats mean/var
  prelu   weight -> alpha
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as tnn
from torch.overrides import TorchFunctionMode

from .convert import flax_init_variables

__all__ = [
    'FlaxUnit', 'TorchUnit', 'flax_leaf_order', 'torch_leaf_order',
    'sd_leaf_units', 'apply_units', 'transplant_from_module',
    'import_reference_state_dict', 'load_reference_pth', 'SD_REORDER',
]


@dataclass
class FlaxUnit:
    path: Tuple[str, ...]     # scope path into variables['params']
    kind: str                 # conv | deconv | bn | dense | prelu | ...


@dataclass
class TorchUnit:
    name: str                 # torch module path ('' for root-level)
    kind: str                 # conv | deconv | bn | dense | prelu | conv4d
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)

    def describe(self) -> str:
        shapes = {k: tuple(v.shape) for k, v in self.arrays.items()}
        return f'{self.name} [{self.kind}] {shapes}'


def _kinds():
    """(module type, unit kind), the port's own PReLU included (its
    GroupNorm is an nn.GroupNorm, its BatchNorm holds an nn.BatchNorm2d);
    ConvTranspose2d before Conv2d (both _ConvNd)."""
    from ..nn.modules import PReLU
    return [(tnn.ConvTranspose2d, 'deconv'), (tnn.Conv2d, 'conv'),
            (tnn.modules.batchnorm._BatchNorm, 'bn'),
            (tnn.LayerNorm, 'layernorm'), (tnn.GroupNorm, 'groupnorm'),
            (tnn.Linear, 'dense'), (PReLU, 'prelu'), (tnn.PReLU, 'prelu')]


def _torch_kind(mod) -> Optional[str]:
    for cls, kind in _kinds():
        if isinstance(mod, cls):
            return kind
    return None


def _own_tensors(mod) -> bool:
    return (any(True for _ in mod.parameters(recurse=False)) or
            any(n != 'num_batches_tracked'
                for n, _ in mod.named_buffers(recurse=False)))


class _FirstUse(TorchFunctionMode):
    """Records, in order, the leaves whose tensors a torch call takes
    (`tensors`: id of a parameter or buffer -> its leaf's index)."""

    def __init__(self, tensors: Dict[int, int]):
        super().__init__()
        self.tensors = tensors
        self.order: List[int] = []
        self.seen = set()

    def _note(self, obj) -> None:
        if isinstance(obj, torch.Tensor):
            leaf = self.tensors.get(id(obj))
            if leaf is not None and leaf not in self.seen:
                self.seen.add(leaf)
                self.order.append(leaf)
        elif isinstance(obj, (list, tuple)):
            for o in obj:
                self._note(o)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._note(args)
        self._note(tuple(kwargs.values()))
        return func(*args, **kwargs)


def _leaves(model: tnn.Module):
    """[(name, module, kind)] of the modules of `model` that hold their
    own tensors; a holder of another type raises."""
    out = []
    for name, mod in model.named_modules():
        if not _own_tensors(mod):
            continue
        kind = _torch_kind(mod)
        if kind is None:
            own = {n for n, _ in mod.named_parameters(recurse=False)}
            own |= {n for n, _ in mod.named_buffers(recurse=False)}
            own.discard('num_batches_tracked')
            raise NotImplementedError(
                f'Unsupported parameterized torch leaf {name}: '
                f'{type(mod).__name__} with {sorted(own)}')
        out.append((name, mod, kind))
    return out


def _use_order(model: tnn.Module, forward: Callable[[tnn.Module], None]
               ) -> Tuple[list, List[int]]:
    """The leaves of `model` and the indices of those `forward(model)`
    uses, in the order of first use (under no_grad)."""
    leaves = _leaves(model)
    tensors = {}
    for i, (_, mod, _) in enumerate(leaves):
        for t in (*mod.parameters(recurse=False),
                  *mod.buffers(recurse=False)):
            tensors[id(t)] = i
    mode = _FirstUse(tensors)
    with torch.no_grad(), mode:
        forward(model)
    return leaves, mode.order


# --------------------------------------------------------------- flax ordering

def flax_leaf_order(model: tnn.Module, x_nhwc, seed: int = 0
                    ) -> Tuple[dict, List[FlaxUnit]]:
    """(flax_init_variables(model, seed), [FlaxUnit] in the order the
    Flax twin's init calls its leaves), from one training forward of a
    copy of `model` on the NHWC `x_nhwc` (numpy or a tensor; dropout keeps
    everything)."""
    from ..nn.modules import bind_dropout
    work = copy.deepcopy(model).cpu().float().train()
    x = torch.as_tensor(np.asarray(x_nhwc), dtype=torch.float32)
    keep = lambda path, shape, p: torch.ones(shape, dtype=torch.bool)  # noqa: E731

    def forward(m):
        with bind_dropout(m, keep):
            m(x)

    leaves, order = _use_order(work, forward)
    used = set(order)
    first = [i for i in range(len(leaves)) if i not in used]
    units = [FlaxUnit(tuple(leaves[i][0].split('.')), leaves[i][2])
             for i in first + order]
    return flax_init_variables(model, seed), units


# -------------------------------------------------------------- torch ordering

def _torch_unit(name: str, mod, kind: str) -> TorchUnit:
    arrays = {n: p.detach().cpu().numpy()
              for n, p in mod.named_parameters(recurse=False)}
    arrays.update({n: b.detach().cpu().numpy()
                   for n, b in mod.named_buffers(recurse=False)
                   if n != 'num_batches_tracked'})
    return TorchUnit(name, kind, arrays)


def torch_leaf_order(model: tnn.Module, forward: Callable
                     ) -> List[TorchUnit]:
    """Run `forward(model)` under no_grad and return its parameterized
    leaves in the order of first use; a leaf the forward never uses
    raises."""
    leaves, order = _use_order(model, forward)
    missing = [leaves[i][0] for i in range(len(leaves)) if i not in
               set(order)]
    if missing:
        raise RuntimeError(
            f'torch leaves never called by forward (dead params?): {missing}')
    return [_torch_unit(*leaves[i]) for i in order]


def sd_leaf_units(sd: Dict[str, np.ndarray]) -> List[TorchUnit]:
    """Group a state_dict into leaf units in registration (key) order.

    Conv vs ConvTranspose is not decidable from a 4-D weight alone; such
    units get kind 'conv4d' and are resolved against the flax side's
    expectation in `apply_units`.

    Assumption: any {1-d weight + bias} group with no running stats is a
    LayerNorm. An affine BatchNorm with track_running_stats=False or a
    GroupNorm has the same state_dict shape and would be mis-kinded here —
    no reference model uses either, and a future one surfaces as a loud
    kind-mismatch in `apply_units` (flax side expects scale/bias under a
    BatchNorm/GroupNorm scope), never as silent corruption.
    """
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    order: List[str] = []
    for key, val in sd.items():
        if key.endswith('num_batches_tracked'):
            continue
        prefix, leaf = key.rsplit('.', 1) if '.' in key else ('', key)
        if prefix not in groups:
            groups[prefix] = {}
            order.append(prefix)
        groups[prefix][leaf] = np.asarray(val)
    units = []
    for prefix in order:
        g = groups[prefix]
        if 'running_mean' in g:
            kind = 'bn'
        elif 'weight' in g and g['weight'].ndim == 4:
            kind = 'conv4d'
        elif 'weight' in g and g['weight'].ndim == 2:
            kind = 'dense'
        elif 'weight' in g and g['weight'].ndim == 1 and 'bias' in g:
            kind = 'layernorm'
        elif 'weight' in g and g['weight'].ndim == 1 and len(g) == 1:
            kind = 'prelu'
        else:
            raise NotImplementedError(
                f'Cannot classify state_dict group {prefix}: '
                f'{ {k: v.shape for k, v in g.items()} }')
        units.append(TorchUnit(prefix, kind, g))
    return units



# --------------------------------------------------------------- the transfer

def _tree_get(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


def _tree_set(tree, path, leaf, value):
    node = _tree_get(tree, path)
    cur = np.asarray(node[leaf])
    if tuple(cur.shape) != tuple(value.shape):
        raise ValueError(f'{"/".join(path)}/{leaf}: flax {cur.shape} != '
                         f'torch-mapped {value.shape}')
    node[leaf] = value.astype(cur.dtype)


def _context(flax_units, torch_units, i, radius=3) -> str:
    lines = []
    for j in range(max(0, i - radius), min(len(flax_units), i + radius + 1)):
        fu = flax_units[j]
        tu = torch_units[j].describe() if j < len(torch_units) else '<none>'
        mark = '>>' if j == i else '  '
        lines.append(f'{mark} [{j}] flax {"/".join(fu.path)} ({fu.kind})  '
                     f'<-  torch {tu}')
    return '\n'.join(lines)


def _copy_tree(tree) -> dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def apply_units(variables, flax_units: Sequence[FlaxUnit],
                torch_units: Sequence[TorchUnit]) -> dict:
    """Zip the two unit lists and write torch arrays into a copy of
    `variables` (Flax-path numpy dicts: params + batch_stats). Raises
    with aligned context on any count/kind/shape mismatch."""
    if len(flax_units) != len(torch_units):
        dump = '\n'.join(
            f'[{j}] flax {"/".join(f.path)} ({f.kind})  <-  torch '
            f'{torch_units[j].describe() if j < len(torch_units) else "<none>"}'
            for j, f in enumerate(flax_units))
        extra = '\n'.join(f'[{j}] flax <none>  <-  torch {t.describe()}'
                          for j, t in enumerate(torch_units)
                          if j >= len(flax_units))
        raise ValueError(
            f'Unit count mismatch: flax {len(flax_units)} vs torch '
            f'{len(torch_units)}\n{dump}\n{extra}')

    variables = _copy_tree(variables)
    params = variables['params']
    batch_stats = variables.get('batch_stats', {})

    for i, (fu, tu) in enumerate(zip(flax_units, torch_units)):
        # LayerNorm and GroupNorm are both a bare {1-d weight, bias} pair
        # in a state_dict (sd_leaf_units cannot tell them apart), and both
        # map to flax {scale, bias}: either naming is accepted
        ok = (fu.kind == tu.kind or
              (tu.kind == 'conv4d' and fu.kind in ('conv', 'deconv')) or
              (fu.kind in ('layernorm', 'groupnorm') and
               tu.kind in ('layernorm', 'groupnorm')))
        if not ok:
            raise ValueError(f'Kind mismatch at unit {i}:\n'
                             f'{_context(flax_units, torch_units, i)}')
        try:
            a = tu.arrays
            if fu.kind in ('conv', 'deconv'):
                _tree_set(params, fu.path, 'kernel',
                          np.transpose(a['weight'], (2, 3, 1, 0)))
                if 'bias' in a:
                    _tree_set(params, fu.path, 'bias', a['bias'])
            elif fu.kind == 'dense':
                _tree_set(params, fu.path, 'kernel', a['weight'].T)
                if 'bias' in a:
                    _tree_set(params, fu.path, 'bias', a['bias'])
            elif fu.kind == 'bn':
                _tree_set(params, fu.path, 'scale', a['weight'])
                _tree_set(params, fu.path, 'bias', a['bias'])
                _tree_set(batch_stats, fu.path, 'mean', a['running_mean'])
                _tree_set(batch_stats, fu.path, 'var', a['running_var'])
            elif fu.kind in ('layernorm', 'groupnorm'):
                _tree_set(params, fu.path, 'scale', a['weight'])
                _tree_set(params, fu.path, 'bias', a['bias'])
            elif fu.kind == 'prelu':
                _tree_set(params, fu.path, 'alpha', a['weight'])
            else:
                raise AssertionError(fu.kind)
        except (ValueError, KeyError) as e:
            raise ValueError(
                f'Transplant failed at unit {i}: {e}\n'
                f'{_context(flax_units, torch_units, i)}') from e
    return variables


def transplant_from_module(torch_model, model: tnn.Module, x_nhwc,
                           torch_forward: Optional[Callable] = None,
                           seed: int = 0):
    """Transplant by call order: `torch_model`'s leaves in their order of
    first use in `torch_forward(torch_model)` (default: an eval forward on
    the NCHW transpose of `x_nhwc`) onto the port model's Flax-path tree.
    Returns (variables, flax_units, torch_units)."""
    if torch_forward is None:
        def torch_forward(m):
            m(torch.from_numpy(
                np.transpose(np.asarray(x_nhwc), (0, 3, 1, 2)).copy()))
    variables, flax_units = flax_leaf_order(model, x_nhwc, seed)
    torch_units = torch_leaf_order(torch_model, torch_forward)
    return (apply_units(variables, flax_units, torch_units),
            flax_units, torch_units)


# ----------------------------------------------------- .pth migration surface

def _is_under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + '.')


def swap_sibling_runs(units: List[TorchUnit], first: str,
                      second: str) -> List[TorchUnit]:
    """Registration put `<parent>.second` units before `<parent>.first`, but
    call order is first-then-second: swap every such pair of contiguous runs
    (e.g. reference bisenetv2.py:136-152 GatherExpansionLayer registers
    right_branch before left_branch yet calls left first)."""
    out = list(units)
    i = 0
    while i < len(out):
        name = out[i].name
        pos = name.find(f'.{second}.')
        if pos < 0:
            i += 1
            continue
        parent = name[:pos]
        sec, fst = f'{parent}.{second}', f'{parent}.{first}'
        j = i
        while j < len(out) and _is_under(out[j].name, sec):
            j += 1
        k = j
        while k < len(out) and _is_under(out[k].name, fst):
            k += 1
        if j > i and k > j:
            out[i:k] = out[j:k] + out[i:j]
        i = k if k > i else i + 1
    return out


def order_children(units: List[TorchUnit], parent: str,
                   children: Sequence[str]) -> List[TorchUnit]:
    """Reorder the units under `parent` ('' = the whole model) so its direct
    children appear in the given call order (each child's internal order
    preserved). Children absent from the list keep their relative position
    after the listed ones."""
    def under_parent(name):
        return True if parent == '' else _is_under(name, parent)

    def child_prefix(c):
        return c if parent == '' else f'{parent}.{c}'

    idxs = [i for i, u in enumerate(units) if under_parent(u.name)]
    if not idxs:
        return list(units)
    lo, hi = idxs[0], idxs[-1] + 1
    block = units[lo:hi]
    assert all(under_parent(u.name) for u in block), \
        f'units under {parent!r} are not contiguous'

    def rank(u):
        for ci, c in enumerate(children):
            if _is_under(u.name, child_prefix(c)):
                return ci
        return len(children)

    block = sorted(block, key=rank)          # stable sort
    return units[:lo] + block + units[hi:]


def order_siblings(units: List[TorchUnit],
                   children: Sequence[str]) -> List[TorchUnit]:
    """Wherever a contiguous run of units belongs to one parent and each
    unit's child-component is in `children`, stable-sort the run into the
    `children` order. Applies at every depth (e.g. every enet Bottleneck's
    [left_conv, right_init_conv, right_last_conv] run becomes
    right-then-left, matching the forward call order)."""
    def split(u):
        parts = u.name.split('.')
        for d, comp in enumerate(parts):
            if comp in children:
                return '.'.join(parts[:d]), comp
        return None, None

    out = list(units)
    i = 0
    while i < len(out):
        parent, comp = split(out[i])
        if comp is None:
            i += 1
            continue
        j = i
        while j < len(out):
            p2, c2 = split(out[j])
            if p2 != parent or c2 is None:
                break
            j += 1
        out[i:j] = sorted(out[i:j],
                          key=lambda u: children.index(split(u)[1]))
        i = j
    return out


def _fix_bisenetv2(units):
    units = order_children(units, 'semantic_branch', [
        'stage1to2', 'seg_head2', 'stage3', 'seg_head3', 'stage4',
        'seg_head4', 'stage5_1to4', 'seg_head5', 'stage5_5'])
    return swap_sibling_runs(units, 'left_branch', 'right_branch')


def _fix_ddrnet(units):
    # aux head runs between conv4 and conv5 (reference ddrnet.py:40-53);
    # Stage5 runs DAPPM on the low path before the final high blocks
    # (ddrnet.py:152-163)
    units = order_children(units, '', [
        'conv1', 'conv2', 'conv3', 'conv4', 'aux_head', 'conv5', 'seg_head'])
    return order_children(units, 'conv5', [
        'low_conv1', 'high_conv1', 'bilateral_fusion', 'low_conv2', 'dappm',
        'high_conv2'])


def _fix_stdc(units):
    # aux heads interleave with stages; arm/conv pairs run deep-to-shallow;
    # detail_head after seg_head (reference stdc.py:59-101). detail_conv is
    # never called by forward (trainer-invoked, seg_trainer.py:74) — the
    # Flax twin materializes it first during init, so it sorts first here.
    return order_children(units, '', [
        'detail_conv', 'stage1', 'stage2', 'stage3', 'aux_head3', 'stage4',
        'aux_head4', 'stage5', 'aux_head5', 'arm5', 'conv5', 'arm4', 'conv4',
        'ffm', 'seg_head', 'detail_head'])


def _fix_enet(units):
    # Bottleneck runs its right branch before the left shortcut
    # (reference enet.py:165-180)
    return order_siblings(units, ['right_init_conv', 'right_last_conv',
                                  'left_conv'])


def _fix_espnet(units):
    # DilatedConv reduces with conv_k1 before conv_kn (espnet.py:209-210)
    return order_siblings(units, ['conv_k1', 'conv_kn'])


def _fix_aglnet(units):
    # GAUM: spatial attention on the low path runs before the up-conv
    # (aglnet.py:141-143)
    return order_siblings(units, ['sab', 'up_conv', 'cab'])


def _fix_lednet(units):
    # AttentionPyramidNetwork walks the left ladder top-down then back up
    # (lednet.py:109-135)
    return order_siblings(units, [
        'left_conv1_1', 'left_conv2_1', 'left_conv3', 'left_conv2_2',
        'left_conv1_2', 'mid_branch', 'right_branch'])


def _fix_mininetv2(units):
    # the refinement branch runs first (mininetv2.py:35-48); the dilated
    # depth-wise branch runs before the point-wise merge (mininetv2.py:77-82)
    units = order_children(units, '', [
        'ref', 'd1_2', 'm1_10', 'd3', 'feature_extractor', 'up1', 'm26_29',
        'output'])
    return order_siblings(units, ['dw_conv', 'ddw_conv', 'pw_conv'])


def _fix_bisenetv1(units):
    # ContextPath refines the deepest (1/32) feature before 1/16
    # (bisenetv1.py:60-71)
    return order_children(units, 'context_path', [
        'backbone', 'arm_32', 'conv_32', 'arm_16', 'conv_16'])


def _fix_icnet(units):
    # the shared backbone runs first (low-res branch), then PPM, then the
    # high-res bottom branch (icnet.py:33-57); the CFF aux classifier runs
    # before the fusion convs (icnet.py:78-84)
    units = order_children(units, '', [
        'backbone', 'ppm', 'bottom_branch', 'cff42', 'cff21', 'seg_head'])
    return order_siblings(units, ['classifier', 'conv1', 'conv2'])


def _fix_canet(units):
    # FeatureCrossAttention applies spatial/channel attention before the
    # init conv (canet.py:75-80)
    return order_siblings(units, ['sa', 'ca', 'conv_init'])


def _fix_fssnet(units):
    # DownsamplingBlock runs its pool branch before the conv branch
    # (fssnet.py:116-121)
    return order_siblings(units, ['pool', 'conv'])


def _fix_lite_hrnet(units):
    # FusionBlock ModuleLists register stream-by-stream but the forward
    # walks output-by-output across streams (lite_hrnet.py:245-265)
    order = ['stream2.0', 'stream1.1', 'stream1.2', 'stream2.2',
             'stream3.0', 'stream3.1', 'stream1.3', 'stream2.3', 'stream3.3',
             'stream4.0', 'stream4.1', 'stream4.2']
    parents = {u.name[:u.name.index('.stream')]
               for u in units if '.stream' in u.name}
    for p in sorted(parents):
        units = order_children(units, p, order)
    return units


def _fix_regseg(units):
    # Decoder registers conv_d4_stage1 before conv_d8_stage2 but the forward
    # finishes the d8 path first (reference regseg.py:147-157)
    return order_children(units, 'decoder', [
        'conv_d16', 'conv_d8_stage1', 'conv_d8_stage2', 'conv_d4_stage1',
        'conv_d4_stage2'])


def _fix_smp_unetpp(units):
    # smp UnetPlusPlusDecoder registers the dense grid ModuleDict
    # column-major (x_0_0; x_0_1, x_1_1; x_0_2, ...) but the forward walks it
    # diagonal-major (x_d_d first, then each dense layer)
    call = ['x_0_0', 'x_1_1', 'x_2_2', 'x_3_3', 'x_0_1', 'x_1_2', 'x_2_3',
            'x_0_2', 'x_1_3', 'x_0_3', 'x_0_4']
    return order_children(units, 'decoder.blocks', call)


def _fix_smp_manet(units):
    # MFAB registers SE_ll before SE_hl but gates the (upsampled) high path
    # first
    return order_siblings(units, ['SE_hl', 'SE_ll'])


def _fix_smp_pan(units):
    # GAUBlock registers conv1 (the gate) before conv2 (the low-path conv)
    # but the forward runs conv2 first
    for g in ('gau3', 'gau2', 'gau1'):
        units = order_children(units, f'decoder.{g}', ['conv2', 'conv1'])
    return units


# Architectures whose torch registration order differs from call order need a
# permutation before zipping. Each entry maps model name -> fn(units)->units.
# Correctness of every entry (and of every identity default) is pinned by
# the JAX package's tests/test_logit_parity.py and tests/test_smp_parity.py;
# tests/test_torch_transplant.py holds this copy to that one.
SD_REORDER: Dict[str, Callable[[List[TorchUnit]], List[TorchUnit]]] = {
    'regseg': _fix_regseg,
    'smp_unetpp': _fix_smp_unetpp,
    'smp_manet': _fix_smp_manet,
    'smp_pan': _fix_smp_pan,
    'bisenetv2': _fix_bisenetv2,
    'ddrnet': _fix_ddrnet,
    'stdc': _fix_stdc,
    'enet': _fix_enet,
    'espnet': _fix_espnet,
    'aglnet': _fix_aglnet,
    'lednet': _fix_lednet,
    'mininetv2': _fix_mininetv2,
    'fssnet': _fix_fssnet,
    'lite_hrnet': _fix_lite_hrnet,
    'bisenetv1': _fix_bisenetv1,
    'icnet': _fix_icnet,
    'canet': _fix_canet,
}


def import_reference_state_dict(sd, model_name: str, model: tnn.Module,
                                x_nhwc, seed: int = 0) -> dict:
    """Map a reference-framework state_dict (registration order + the
    per-architecture reorder fixups) onto the port model's Flax-path
    tree. Returns the variables (load them with
    utils/convert.py::load_jax_variables)."""
    variables, flax_units = flax_leaf_order(model, x_nhwc, seed)
    units = sd_leaf_units(sd)
    fix = SD_REORDER.get(model_name)
    if fix is not None:
        units = fix(units)
    return apply_units(variables, flax_units, units)


def load_reference_pth(path: str, model_name: str, model: tnn.Module,
                       x_nhwc, seed: int = 0) -> dict:
    """Load a reference-trained .pth (reference core/base_trainer.py:
    142-149 stores {'state_dict': ...}) and import it: the .pth migration
    entry point."""
    from .torch_import import load_torch_state_dict
    return import_reference_state_dict(load_torch_state_dict(path),
                                       model_name, model, x_nhwc, seed)
