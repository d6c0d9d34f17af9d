"""Module vocabulary for the port's models (counterpart of
rtseg_tpu/nn/modules.py).

Modules run on NCHW tensors (a permuted NHWC input is already a
channels_last NCHW tensor). Attribute names are the Flax scope names of
the JAX package (`Conv_0.conv`, `BatchNorm_0.bn`, `Activation_0.prelu`),
so the weight converter (utils/convert.py) is a mechanical path map.

Precision follows the JAX package: a conv casts its float32 weights to the
activation type for each call (bf16 activations run bf16 convs with float32
accumulation), and BatchNorm keeps float32 parameters and statistics,
normalizing in float32 and returning the activation type.

LayerNorm and GroupNorm compute Flax's formula (`use_fast_variance`):
float32 statistics E[x] and E[x^2] - E[x]^2 clipped at 0, as BatchNorm's
training statistics.

Dropout, and MixTransformer's drop path, take their keep masks from a mask
source bound for the forward (`bind_dropout`), not from a global
generator: the train step binds one drawn from its per-step generator, and
tests bind given masks.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pool import adaptive_avg_pool_nchw
from ..ops.resize import resize_bilinear_nchw

Size2 = Union[int, Tuple[int, int]]


def _pair(v: Size2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


# ------------------------------------------------------------------ activation

class PReLU(nn.Module):
    """One learned negative slope (init 0.25), cast to the input type."""

    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def _glu(x):
    a, b = torch.chunk(x, 2, dim=1)
    return a * torch.sigmoid(b)


# 16-entry hub mirroring rtseg_tpu/nn/modules.py ACTIVATIONS; the channel
# axis of NCHW is dim 1
ACTIVATIONS: dict = {
    'relu': F.relu,
    'relu6': lambda x: torch.clamp(x, 0, 6),
    'leakyrelu': lambda x: F.leaky_relu(x, 0.01),
    'prelu': 'prelu',            # parameterized; handled in Activation
    'celu': F.celu,
    'elu': F.elu,
    'hardswish': F.hardswish,
    'hardtanh': lambda x: torch.clamp(x, -1, 1),
    'gelu': lambda x: F.gelu(x, approximate='none'),
    'glu': _glu,
    'selu': F.selu,
    'silu': F.silu,
    'sigmoid': torch.sigmoid,
    'softmax': lambda x: torch.softmax(x, dim=1),
    'tanh': torch.tanh,
    'none': lambda x: x,
}


class Activation(nn.Module):
    """Name-dispatched activation."""

    def __init__(self, act_type: str = 'relu', device=None):
        super().__init__()
        act = act_type.lower()
        if act not in ACTIVATIONS:
            raise NotImplementedError(f'Unsupported activation type: {act}')
        self.act = act
        if act == 'prelu':
            self.prelu = PReLU(device)

    def forward(self, x):
        if self.act == 'prelu':
            return self.prelu(x)
        return ACTIVATIONS[self.act](x)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer` applied as Flax's Dense without a `dtype`: the input and the
    parameters promoted to their common type, so a bf16 input to float32
    parameters gives a float32 output."""
    t = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(t), layer.weight.to(t), layer.bias.to(t))


def dense_as_input(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer` applied as Flax's Dense with `dtype=x.dtype`: the float32
    parameters cast to the input's type, so a bf16 input gives a bf16
    output (MixTransformer's projections)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


# ---------------------------------------------------- LayerNorm and GroupNorm

def _fast_stats(xf: torch.Tensor, dims):
    """Flax's fast-variance statistics over `dims` of a float32 (or
    float64) tensor: E[x] and E[x^2] - E[x]^2 clipped at 0."""
    mean = xf.mean(dims, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dims, keepdim=True) - mean * mean,
                          0.0)
    return mean, var


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Flax's nn.LayerNorm over the last axis of `x`: float32 statistics
    (`_fast_stats`), (x - mean) * (rsqrt(var + eps) * scale) + bias in
    float32, returned in the input's type."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, var = _fast_stats(xf, (-1,))
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Flax's nn.GroupNorm over NCHW `x`, computed on its NHWC view as
    Flax computes it: statistics of each sample and group of channels
    (`_fast_stats`), normalized in float32, returned in the input's type.
    A channels_last input gives a channels_last output."""
    xh = x.permute(0, 2, 3, 1)
    n, h, w, c = xh.shape
    xf = xh.to(torch.promote_types(x.dtype, torch.float32)).reshape(
        n, h, w, groups, c // groups)
    mean, var = _fast_stats(xf, (1, 2, 4))
    g = (groups, c // groups)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight.reshape(g)) \
        + bias.reshape(g)
    return y.reshape(n, h, w, c).to(x.dtype).permute(0, 3, 1, 2)


class LayerNorm(nn.Module):
    """MixTransformer's LayerNorm (rtseg_tpu/models/mit.py LayerNorm): eps
    1e-6, float32 parameters in `ln` (the Flax scope), over the last
    axis."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.ln = nn.LayerNorm(channels, eps=eps, device=device)

    def forward(self, x):
        ln = self.ln
        return layer_norm(x, ln.weight, ln.bias, ln.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW, eps 1e-5, float32 parameters, computed as
    Flax's nn.GroupNorm (`group_norm`) rather than F.group_norm, whose
    variance is computed otherwise."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 device=None):
        super().__init__(num_groups, channels, eps=eps, device=device)

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps)


# ------------------------------------------------------------------------- BN

def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, eps: float = 1e-5,
                     momentum: float = 0.9,
                     update_stats: bool = True,
                     sync: Optional[Callable] = None) -> torch.Tensor:
    """Train-mode BatchNorm over NCHW `x`, as Flax computes it: float32
    (float64 for a float64 input) batch statistics E[x] and
    E[x^2] - E[x]^2 clipped at 0 (the biased variance), which both
    normalize `x` and, unless `update_stats` is False, update the running
    statistics in place, ra = momentum * ra + (1 - momentum) * batch.
    Returns the input's type.

    `sync`, where given, averages the stacked [E[x], E[x^2]] over the
    ranks before the variance is formed, differentiably (data parallel
    under config.sync_bn: parallel/mesh.py `all_reduce_mean_grad`), as
    Flax's BatchNorm with an axis_name averages them with one lax.pmean:
    the statistics of the global batch.

    nn.BatchNorm2d would update running_var with the unbiased variance
    (n / (n - 1) larger), which at the 1/32-resolution aux heads of a small
    batch (a few values a channel) moves the statistics by tens of
    percent; nn.SyncBatchNorm too, and its variance is Welford's."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = (0, 2, 3)
    if sync is None:
        mean = xf.mean(dims)
        mean2 = (xf * xf).mean(dims)
    else:
        mean, mean2 = sync(torch.stack([xf.mean(dims),
                                        (xf * xf).mean(dims)])).unbind(0)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    if update_stats:
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean.detach() * (1.0 - momentum))
            running_var.mul_(momentum).add_(var.detach() * (1.0 - momentum))
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm2d, eps 1e-5, Flax momentum 0.9 (ema = 0.9*ema + 0.1*new).
    Eval uses the running statistics; training runs `batch_norm_train`,
    which leaves them as they are while `frozen_stats` is set (the
    recompute of a rematerialized forward, `Recompute`) and averages the
    batch statistics over the ranks through `sync_stats` while one is
    bound (`sync_batch_norm`: the train step under config.sync_bn in a
    process group; eval never syncs)."""

    frozen_stats = False
    sync_stats: Optional[Callable] = None

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.bn = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1,
                                 device=device)

    def forward(self, x):
        if not self.training:
            return self.bn(x)
        bn = self.bn
        return batch_norm_train(x, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps,
                                update_stats=not self.frozen_stats,
                                sync=self.sync_stats)


def batch_norms(model: nn.Module) -> List[BatchNorm]:
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


@contextmanager
def sync_batch_norm(norms: Sequence[BatchNorm], sync: Callable):
    """Bind `sync` (stacked statistics -> their average over the ranks) to
    the BatchNorms `norms` for the block, the backward's recompute of a
    rematerialized forward included: an attribute of each module, set and
    restored, not a process-global switch."""
    for m in norms:
        m.sync_stats = sync
    try:
        yield
    finally:
        for m in norms:
            m.sync_stats = None


# ------------------------------------------------------------------ conv cores

class Conv(nn.Module):
    """Conv2d with torch-style symmetric padding (k-1)//2*d, groups and
    dilation; float32 weights cast to the input type per call."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size2 = 3, stride: Size2 = 1,
                 dilation: Size2 = 1, groups: int = 1,
                 use_bias: bool = False, padding: Optional[Size2] = None,
                 device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        dh, dw = _pair(dilation)
        if padding is None:
            padding = ((kh - 1) // 2 * dh, (kw - 1) // 2 * dw)
        self.conv = nn.Conv2d(in_channels, out_channels, (kh, kw),
                              stride=_pair(stride), padding=_pair(padding),
                              dilation=(dh, dw), groups=groups,
                              bias=use_bias, device=device)

    def forward(self, x):
        c = self.conv
        bias = None if c.bias is None else c.bias.to(x.dtype)
        return F.conv2d(x, c.weight.to(x.dtype), bias, c.stride, c.padding,
                        c.dilation, c.groups)


def conv3x3(in_channels: int, out_channels: int, stride: Size2 = 1,
            bias: bool = False, device=None) -> Conv:
    return Conv(in_channels, out_channels, 3, stride, use_bias=bias,
                device=device)


def conv1x1(in_channels: int, out_channels: int, stride: Size2 = 1,
            bias: bool = False, device=None) -> Conv:
    return Conv(in_channels, out_channels, 1, stride, use_bias=bias,
                device=device)


class ConvBNAct(nn.Module):
    """Conv -> BN -> Activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size2 = 3, stride: Size2 = 1,
                 dilation: Size2 = 1, groups: int = 1, bias: bool = False,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels, kernel_size, stride,
                           dilation, groups, bias, device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, x):
        return self.Activation_0(self.BatchNorm_0(self.Conv_0(x)))


class DWConvBNAct(ConvBNAct):
    """Depth-wise conv -> BN -> act: groups = input channels; the output may
    be a multiple of them (the depthwise multiplier)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size2 = 3, stride: Size2 = 1,
                 dilation: Size2 = 1, act_type: str = 'relu', device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         dilation, groups=in_channels, bias=False,
                         act_type=act_type, device=device)


class PWConvBNAct(ConvBNAct):
    """Point-wise conv -> BN -> act (bias on by default)."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', bias: bool = True, device=None):
        super().__init__(in_channels, out_channels, 1, bias=bias,
                         act_type=act_type, device=device)


class DSConvBNAct(nn.Module):
    """Depth-wise separable conv: DWConvBNAct (same channels) ->
    PWConvBNAct (bias on)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Size2 = 3, stride: Size2 = 1,
                 dilation: Size2 = 1, act_type: str = 'relu', device=None):
        super().__init__()
        self.DWConvBNAct_0 = DWConvBNAct(in_channels, in_channels,
                                         kernel_size, stride, dilation,
                                         act_type, device=device)
        self.PWConvBNAct_0 = PWConvBNAct(in_channels, out_channels, act_type,
                                         device=device)

    def forward(self, x):
        return self.PWConvBNAct_0(self.DWConvBNAct_0(x))


class DeConvBNAct(nn.Module):
    """Transposed conv (with a bias) -> BN -> act, torch ConvTranspose2d
    geometry: kernel 2*scale-1 unless given, stride scale, padding
    (k-1)//2, output_padding scale-1 unless given, so the defaults upsample
    exactly scale x. The weight is (in, out, k, k); float32, cast to the
    input type per call like Conv's."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 2, kernel_size: Optional[int] = None,
                 act_type: str = 'relu',
                 output_padding: Optional[int] = None, device=None):
        super().__init__()
        k = kernel_size if kernel_size is not None else 2 * scale_factor - 1
        out_pad = output_padding if output_padding is not None \
            else scale_factor - 1
        self.deconv = nn.ConvTranspose2d(
            in_channels, out_channels, k, stride=scale_factor,
            padding=(k - 1) // 2, output_padding=out_pad, bias=True,
            device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, x):
        d = self.deconv
        x = F.conv_transpose2d(x, d.weight.to(x.dtype), d.bias.to(x.dtype),
                               d.stride, d.padding, d.output_padding)
        return self.Activation_0(self.BatchNorm_0(x))


# -------------------------------------------------------------------- dropout

# a mask source: (module path, NCHW mask shape, keep probability) -> bool
# keep mask of that shape, on any device
MaskSource = Callable[[str, Tuple[int, ...], float], torch.Tensor]


class DropoutMasks:
    """Keep masks drawn from `generator`, on its device: uniform < keep
    probability, as Flax's random.bernoulli draws them. The uniforms are
    drawn in NHWC order and handed back as a channels_last NCHW view, the
    models' layout."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, path: str, shape: Tuple[int, ...],
                 keep_prob: float) -> torch.Tensor:
        n, c, h, w = shape
        u = torch.rand((n, h, w, c), generator=self.generator,
                       device=self.generator.device)
        return (u < keep_prob).permute(0, 3, 1, 2)


class Dropout(nn.Module):
    """Flax's nn.Dropout as the JAX package's Dropout applies it: in
    training `where(keep, x / keep_prob, 0)` in the input's type, with
    keep_prob rounded to that type first as JAX rounds the Python scalar
    (F.dropout multiplies by a float32 1 / keep_prob, which rounds
    otherwise in bf16); out of training, or at rate 0, the identity; at
    rate 1, zeros.

    The keep mask comes from the mask source that `bind_dropout` binds for
    a training forward (the train step binds one drawn from its per-step
    generator; tests bind given masks), asked with this module's path in
    the model. A training forward with no source bound raises, as Flax
    raises without a 'dropout' rng: it never quietly runs deterministic.
    """

    # Dropout2d: one draw a sample and channel
    channel_wise = False

    def mask_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The keep mask's shape for an NCHW input of `shape`."""
        n, c, h, w = shape
        return (n, c, 1, 1) if self.channel_wise else (n, c, h, w)

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)
        self.masks: Optional[MaskSource] = None
        self.path = ''

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.masks is None:
            raise RuntimeError(
                f'{type(self).__name__} {self.path!r} in training needs '
                f'keep masks: bind a mask source with bind_dropout (the '
                f'train step binds its per-step generator)')
        shape = self.mask_shape(tuple(x.shape))
        keep = self.masks(self.path, shape, 1.0 - self.rate)
        if tuple(keep.shape) != shape or keep.dtype != torch.bool:
            raise ValueError(f'{self.path}: a keep mask must be bool of '
                             f'shape {shape}, got {keep.dtype} '
                             f'{tuple(keep.shape)}')
        keep_prob = torch.tensor(1.0 - self.rate, dtype=x.dtype).item()
        return torch.where(keep.to(x.device), x / keep_prob, 0.0)


class Dropout2d(Dropout):
    """Drops whole channels: the mask is [N, C, 1, 1], Flax's
    `broadcast_dims=(1, 2)` on NHWC. Rate 0.2 by default."""

    channel_wise = True

    def __init__(self, rate: float = 0.2):
        super().__init__(rate)


class DropPath(Dropout):
    """Stochastic depth (rtseg_tpu/models/mit.py Block): one keep draw a
    sample, the mask (N, 1, 1, 1) over a 4-D input of any layout, and
    Dropout's formula `where(keep, x / keep_prob, 0)`. At rate 0 (the first
    block of the schedule) it is the identity and draws nothing."""

    def mask_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return (shape[0],) + (1,) * (len(shape) - 1)


def dropout_modules(model: nn.Module):
    """[(path, module)] of the Dropout, Dropout2d and DropPath modules of
    `model`."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, Dropout)]


@contextmanager
def bind_dropout(model: nn.Module, masks: MaskSource, modules=None):
    """Bind the mask source `masks` to every dropout of `model` (or to
    `modules`, its `dropout_modules`) for the forwards inside the block,
    and unbind it after."""
    modules = dropout_modules(model) if modules is None else modules
    for name, m in modules:
        m.masks, m.path = masks, name
    try:
        yield
    finally:
        for _, m in modules:
            m.masks = None


# -------------------------------------------------------------------- remat

class Recompute:
    """The contexts of a training forward of `model` under
    torch.utils.checkpoint (config.remat): call it as checkpoint's
    `context_fn`. The JAX forward that jax.checkpoint recomputes is pure;
    the port's is not, so the recompute in the backward

    * leaves BatchNorm's running statistics as the first pass left them
      (`BatchNorm.frozen_stats`), so they move once a step;
    * takes the keep masks of the first pass: the first pass records each
      mask the bound source (`bind_dropout`) gives, and the recompute
      replays them in order, whatever the source (a step's generator,
      which checkpoint's preserve_rng_state does not save, or given
      masks).

    Both are attributes of the model's own modules, set for the block and
    restored after it: no process-global switch."""

    def __init__(self, model: nn.Module):
        self.drops = dropout_modules(model)
        self.norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def __call__(self):
        record = []
        return self._first(record), self._again(record)

    @contextmanager
    def _first(self, record):
        sources = [m.masks for _, m in self.drops]

        def recording(source):
            def masks(path, shape, keep_prob):
                keep = source(path, shape, keep_prob)
                record.append((path, shape, keep))
                return keep
            return masks

        for (_, m), source in zip(self.drops, sources):
            if source is not None:
                m.masks = recording(source)
        try:
            yield
        finally:
            for (_, m), source in zip(self.drops, sources):
                m.masks = source

    @contextmanager
    def _again(self, record):
        replay = iter(record)

        def masks(path, shape, keep_prob):
            got = next(replay, None)
            if got is None or got[:2] != (path, shape):
                raise RuntimeError(f'the recompute asked {path!r} for a mask '
                                   f'of {shape} where the first pass gave '
                                   f'{got[:2] if got else "none"}')
            return got[2]

        sources = [m.masks for _, m in self.drops]
        for _, m in self.drops:
            m.masks = masks
        for m in self.norms:
            m.frozen_stats = True
        try:
            yield
        finally:
            for (_, m), source in zip(self.drops, sources):
                m.masks = source
            for m in self.norms:
                m.frozen_stats = False


# ------------------------------------------------------------- composite heads

class PyramidPoolingModule(nn.Module):
    """PSPNet-style PPM: per pool size an adaptive average pool and a bare
    1x1 conv `stage{i}` to in/4 channels, align-corners upsampled back;
    concatenated with the input and fused by a 1x1 PWConvBNAct."""

    POOL_SIZES = (1, 2, 4, 6)

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', bias: bool = False, device=None):
        super().__init__()
        hid = max(1, in_channels // 4)
        for i in range(len(self.POOL_SIZES)):
            setattr(self, f'stage{i + 1}',
                    Conv(in_channels, hid, 1, device=device))
        self.PWConvBNAct_0 = PWConvBNAct(
            in_channels + hid * len(self.POOL_SIZES), out_channels,
            act_type, bias=bias, device=device)

    def forward(self, x):
        size = x.shape[2:4]
        feats = [x]
        for i, ps in enumerate(self.POOL_SIZES):
            y = getattr(self, f'stage{i + 1}')(adaptive_avg_pool_nchw(x, ps))
            feats.append(resize_bilinear_nchw(y, size, align_corners=True))
        return self.PWConvBNAct_0(torch.cat(feats, dim=1))


class SegHead(nn.Module):
    """3x3 ConvBNAct -> bias-free 1x1 conv to classes."""

    def __init__(self, in_channels: int, num_class: int,
                 act_type: str = 'relu', hid_channels: int = 128,
                 device=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_channels, hid_channels, 3,
                                     act_type=act_type, device=device)
        self.Conv_0 = Conv(hid_channels, num_class, 1, device=device)

    def forward(self, x):
        return self.Conv_0(self.ConvBNAct_0(x))
