"""SQNet (openreview S1uHiFyyg), the port of rtseg_tpu/models/sqnet.py.

A SqueezeNet-1.1 encoder (a strided ConvBNAct, then fire modules between
three max_pool(3,2,1)s) to 1/16, a context module of four dilated 3x3
ConvBNActs summed, and a decoder of 2x transposed convs, each followed by
a bypass refinement with the encoder's features at its scale; the last
transposed conv gives the logits at full size (the eval step takes the
plain argmax; K1 is never launched). ELU throughout. Submodules carry the
Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import ConvBNAct, DeConvBNAct
from ..ops.pool import max_pool_nchw


class FireModule(nn.Module):
    """A 1x1 squeeze, then 1x1 and 3x3 expands concatenated."""

    def __init__(self, in_channels: int, sq_channels: int, ex1_channels: int,
                 ex3_channels: int, act_type: str = 'elu', device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(in_channels, sq_channels, 1, act_type=a,
                                     device=d)
        self.ConvBNAct_1 = ConvBNAct(sq_channels, ex1_channels, 1,
                                     act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(sq_channels, ex3_channels, 3,
                                     act_type=a, device=d)

    def forward(self, x):
        x = self.ConvBNAct_0(x)
        return torch.cat([self.ConvBNAct_1(x), self.ConvBNAct_2(x)], dim=1)


class ParallelDilatedConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dilations=(1, 2, 4, 8), act_type: str = 'elu', device=None):
        super().__init__()
        self.n = len(dilations)
        for i, r in enumerate(dilations):
            setattr(self, f'ConvBNAct_{i}', ConvBNAct(
                in_channels, out_channels, 3, dilation=r, act_type=act_type,
                device=device))

    def forward(self, x):
        out = self.ConvBNAct_0(x)
        for i in range(1, self.n):
            out = out + getattr(self, f'ConvBNAct_{i}')(x)
        return out


class BypassRefinementModule(nn.Module):
    """A 3x3 ConvBNAct over the encoder's features, concatenated with the
    decoder's, and a 3x3 ConvBNAct to `out_channels`."""

    def __init__(self, low_channels: int, high_channels: int,
                 out_channels: int, act_type: str = 'elu', device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(low_channels, low_channels, 3,
                                     act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(low_channels + high_channels,
                                     out_channels, 3, act_type=a, device=d)

    def forward(self, x_low, x_high):
        return self.ConvBNAct_1(torch.cat([self.ConvBNAct_0(x_low), x_high],
                                          dim=1))


class SQNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full size (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, act_type: str = 'elu',
                 device=None):
        super().__init__()
        a, d, nc = act_type, device, num_class
        self.ConvBNAct_0 = ConvBNAct(3, 64, 3, 2, act_type=a, device=d)
        fires = ((64, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
                 (256, 48, 192), (384, 48, 192), (384, 64, 256),
                 (512, 64, 256))
        for i, (cin, sq, ex) in enumerate(fires):
            setattr(self, f'FireModule_{i}',
                    FireModule(cin, sq, ex, ex, a, device=d))
        self.ParallelDilatedConv_0 = ParallelDilatedConv(
            512, 128, (1, 2, 4, 8), a, device=d)
        self.DeConvBNAct_0 = DeConvBNAct(128, 128, act_type=a, device=d)
        self.BypassRefinementModule_0 = BypassRefinementModule(
            256, 128, 128, a, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(128, 128, act_type=a, device=d)
        self.BypassRefinementModule_1 = BypassRefinementModule(
            128, 128, 64, a, device=d)
        self.DeConvBNAct_2 = DeConvBNAct(64, 64, act_type=a, device=d)
        self.BypassRefinementModule_2 = BypassRefinementModule(
            64, 64, nc, a, device=d)
        self.DeConvBNAct_3 = DeConvBNAct(nc, nc, act_type=a, device=d)

    def _fires(self, x, first: int, last: int):
        for i in range(first, last):
            x = getattr(self, f'FireModule_{i}')(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x1 = self.ConvBNAct_0(x)
        x2 = self._fires(max_pool_nchw(x1, 3, 2, 1), 0, 2)
        x3 = self._fires(max_pool_nchw(x2, 3, 2, 1), 2, 4)
        x = self._fires(max_pool_nchw(x3, 3, 2, 1), 4, 8)
        x = self.DeConvBNAct_0(self.ParallelDilatedConv_0(x))
        x = self.DeConvBNAct_1(self.BypassRefinementModule_0(x3, x))
        x = self.DeConvBNAct_2(self.BypassRefinementModule_1(x2, x))
        x = self.DeConvBNAct_3(self.BypassRefinementModule_2(x1, x))
        return x.permute(0, 2, 3, 1)
