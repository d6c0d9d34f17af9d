"""ENet (arXiv:1606.02147), the port of rtseg_tpu/models/enet.py.

`InitialBlock` (a strided conv beside a max pool, concatenated) is also
the stem of CFPNet, DABNet, ERFNet, ESNet, FDDWNet, FSSNet, MiniNetv2,
LEDNet and AGLNet (in several of them the reference calls it a
downsampling block). ENet itself: bottlenecks with dropout, whose
downsampling ones keep the argmax of a 2x2 max pool and whose upsampling
ones unpool into it (ops/pool.py, int8 index maps), and a last `Upsample`
(a 1x1 ConvBNAct and an align_corners=False bilinear resize, not
`final_upsample`) that leaves the logits at full size: the eval step takes
the plain argmax and K1 is never launched. Submodules carry the Flax
scope names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn import Activation, Conv, ConvBNAct, Dropout
from ..ops.pool import (max_pool_argmax_2x2_nchw, max_pool_nchw,
                        max_unpool_2x2_nchw)
from ..ops.resize import resize_bilinear_nchw
from .ddrnet import _Scope


class InitialBlock(nn.Module):
    """A stride-2 ConvBNAct to out - in channels, concatenated with
    max_pool(x, 3, 2, 1) of the input: `out_channels` in all."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'prelu', kernel_size: int = 3,
                 device=None):
        super().__init__()
        if out_channels <= in_channels:
            raise ValueError('out_channels should be larger than '
                             'in_channels.')
        self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels - in_channels,
                                     kernel_size, 2, act_type=act_type,
                                     device=device)

    def forward(self, x):
        return torch.cat([self.ConvBNAct_0(x), max_pool_nchw(x, 3, 2, 1)],
                         dim=1)


class Upsample(nn.Module):
    """`upsample_type='deconvolution'`: a bare bias-free transposed conv,
    kernel 2s-1 unless given, stride s, padding (k-1)//2, output padding 1.
    Otherwise a 1x1 ConvBNAct and a bilinear resize by s with
    align_corners=False."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 2, kernel_size: Optional[int] = None,
                 upsample_type: Optional[str] = None,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.scale = scale_factor
        self.is_deconv = upsample_type == 'deconvolution'
        if self.is_deconv:
            k = kernel_size if kernel_size is not None \
                else 2 * scale_factor - 1
            self.deconv = nn.ConvTranspose2d(
                in_channels, out_channels, k, stride=scale_factor,
                padding=(k - 1) // 2, output_padding=1, bias=False,
                device=device)
        else:
            self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels, 1,
                                         act_type=act_type, device=device)

    def forward(self, x):
        if self.is_deconv:
            d = self.deconv
            return F.conv_transpose2d(x, d.weight.to(x.dtype), None,
                                      d.stride, d.padding, d.output_padding)
        x = self.ConvBNAct_0(x)
        s = self.scale
        return resize_bilinear_nchw(x, (x.shape[2] * s, x.shape[3] * s),
                                    align_corners=False)


class Bottleneck(nn.Module):
    """A 1x1 (or strided 3x3) reduction to in/4, the conv of `conv_type`,
    a bias-free 1x1 conv to out and dropout, added to the identity, to a
    1x1 ConvBNAct of the 2x2 max pool (downsampling, which also returns
    the pool's argmax), or to the unpooled 1x1 ConvBNAct (upsampling, given
    the argmax); then the activation. The inner ConvBNActs use ReLU
    whatever `act_type`, as in the JAX block."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv_type: str = 'regular', act_type: str = 'prelu',
                 upsample_type: str = 'regular', dilation: int = 1,
                 drop_p: float = 0.1, shrink_ratio: float = 0.25,
                 device=None):
        super().__init__()
        hid = int(in_channels * shrink_ratio)
        c, d = in_channels, device
        self.conv_type = ct = conv_type
        if ct == 'regular':
            convs = [ConvBNAct(c, hid, 1, device=d),
                     ConvBNAct(hid, hid, 3, device=d)]
        elif ct == 'downsampling':
            convs = [ConvBNAct(c, hid, 3, 2, device=d),
                     ConvBNAct(hid, hid, 3, device=d)]
        elif ct == 'upsampling':
            convs = [ConvBNAct(c, hid, 1, device=d),
                     Upsample(hid, hid, 2, kernel_size=3,
                              upsample_type=upsample_type, device=d)]
        elif ct == 'dilate':
            convs = [ConvBNAct(c, hid, 1, device=d),
                     ConvBNAct(hid, hid, 3, dilation=dilation, device=d)]
        elif ct == 'asymmetric':
            convs = [ConvBNAct(c, hid, 1, device=d),
                     ConvBNAct(hid, hid, (5, 1), device=d),
                     ConvBNAct(hid, hid, (1, 5), device=d)]
        else:
            raise ValueError(f'[!] Unsupport convolution type: {ct}')
        scope = _Scope(self)
        self.right = [scope.add(m) for m in convs]
        self.Conv_0 = Conv(hid, out_channels, 1, device=d)
        self.Dropout_0 = Dropout(drop_p)
        self.Activation_0 = Activation(act_type, d)
        if ct in ('downsampling', 'upsampling'):
            self.left = scope.add(ConvBNAct(c, out_channels, 1, device=d))

    def forward(self, x, indices=None):
        y = x
        for name in self.right:
            y = getattr(self, name)(y)
        y = self.Dropout_0(self.Conv_0(y))
        if self.conv_type == 'downsampling':
            left, idx = max_pool_argmax_2x2_nchw(x)
            left = getattr(self, self.left)(left)
            return self.Activation_0(left + y), idx
        if self.conv_type == 'upsampling':
            if indices is None:
                raise ValueError('Upsampling-type conv needs pooling '
                                 'indices.')
            left = max_unpool_2x2_nchw(getattr(self, self.left)(x), indices)
            return self.Activation_0(left + y)
        return self.Activation_0(x + y)


class ENet(nn.Module):
    """Takes NHWC images [B, H, W, 3] (H, W multiples of 8) and returns
    NHWC class logits [B, H, W, C] at full size (also with
    `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, act_type: str = 'prelu',
                 upsample_type: str = 'deconvolution', device=None):
        super().__init__()
        a, d = act_type, device
        self.InitialBlock_0 = InitialBlock(3, 16, a, device=d)
        # (in, out, conv_type, dilation, drop_p) in the JAX forward's order
        plan = [(16, 64, 'downsampling', 1, 0.01)] + \
            [(64, 64, 'regular', 1, 0.01)] * 4 + \
            [(64, 128, 'downsampling', 1, 0.1)] + \
            [(128, 128, t, r, 0.1) for t, r in (
                ('regular', 1), ('dilate', 2), ('asymmetric', 1),
                ('dilate', 4), ('regular', 1), ('dilate', 8),
                ('asymmetric', 1), ('dilate', 16))] * 2 + \
            [(128, 64, 'upsampling', 1, 0.1), (64, 64, 'regular', 1, 0.1),
             (64, 64, 'regular', 1, 0.1), (64, 16, 'upsampling', 1, 0.1),
             (16, 16, 'regular', 1, 0.1)]
        scope = _Scope(self)
        self.blocks = [scope.add(Bottleneck(cin, cout, t, a, upsample_type,
                                            r, p, device=d))
                       for cin, cout, t, r, p in plan]
        self.Upsample_0 = Upsample(16, num_class, 2, act_type=a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = self.InitialBlock_0(x.permute(0, 3, 1, 2))
        indices = []
        for name in self.blocks:
            block = getattr(self, name)
            if block.conv_type == 'downsampling':
                x, idx = block(x)
                indices.append(idx)
            elif block.conv_type == 'upsampling':
                x = block(x, indices.pop())
            else:
                x = block(x)
        return self.Upsample_0(x).permute(0, 2, 3, 1)
