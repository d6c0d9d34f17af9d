"""FPENet (arXiv:1909.08599), the port of rtseg_tpu/models/fpenet.py.

A strided ConvBNAct, then feature-pyramid encoding blocks (a 1x1
ConvBNAct expansion split into four channel slices, each through a
depth-wise ConvBNAct of dilation 1, 2, 4 or 8 and summed onto the slice
before it, concatenated, a 1x1 ConvBNAct, and the input added where the
shapes allow) to 1/2, 1/4 and 1/8. Two mutual-embedding upsample modules
(MEU) decode: a spatial gate from a ConvBNAct over the low features'
channel mean, a channel gate from a ConvBNAct over the high features'
global average (in training, its BatchNorm normalizes over the batch's B
values a channel), the gated high features upsampled 2x with align-corners
and added to the gated low ones. A 1x1 ConvBNAct to the classes at 1/2 and
the final align-corners upsample close the model. Submodules carry the
Flax scope names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..nn import ConvBNAct, DWConvBNAct
from ..ops.pool import global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw


class FPEBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, expansion: int,
                 stride: int = 1, dilations: Sequence[int] = (1, 2, 4, 8),
                 act_type: str = 'relu', device=None):
        super().__init__()
        a, d = act_type, device
        self.K = len(dilations)
        self.use_skip = in_channels == out_channels and stride == 1
        expand = out_channels * expansion
        self.ch = ch = expand // self.K
        self.ConvBNAct_0 = ConvBNAct(in_channels, expand, 1, act_type=a,
                                     device=d)
        for i, r in enumerate(dilations):
            setattr(self, f'DWConvBNAct_{i}', DWConvBNAct(
                ch, ch, 3, stride, r, act_type=a, device=d))
        self.ConvBNAct_1 = ConvBNAct(ch * self.K, out_channels, 1,
                                     act_type=a, device=d)

    def forward(self, x):
        residual, ch = x, self.ch
        x = self.ConvBNAct_0(x)
        feats = []
        for i in range(self.K):
            y = getattr(self, f'DWConvBNAct_{i}')(x[:, i * ch:(i + 1) * ch])
            if i > 0:
                y = y + feats[-1]
            feats.append(y)
        x = self.ConvBNAct_1(torch.cat(feats, dim=1))
        return x + residual if self.use_skip else x


class MEUModule(nn.Module):
    def __init__(self, low_channels: int, high_channels: int,
                 out_channels: int, act_type: str = 'relu', device=None):
        super().__init__()
        c, a, d = out_channels, act_type, device
        self.conv_low = ConvBNAct(low_channels, c, 1, act_type=a, device=d)
        self.conv_high = ConvBNAct(high_channels, c, 1, act_type=a,
                                   device=d)
        self.sa = ConvBNAct(1, 1, 1, act_type=a, device=d)
        self.ca = ConvBNAct(c, c, 1, act_type=a, device=d)

    def forward(self, x_low, x_high):
        x_low = self.conv_low(x_low)
        x_high = self.conv_high(x_high)
        # spatial attention from the low features, channel attention from
        # the high ones
        sa = self.sa(x_low.mean(dim=1, keepdim=True))
        ca = self.ca(global_avg_pool_nchw(x_high))
        x_low = x_low * ca
        x_high = resize_bilinear_nchw(
            x_high, (x_high.shape[2] * 2, x_high.shape[3] * 2),
            align_corners=True)
        return x_low + x_high * sa


class FPENet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/2-resolution logits with `defer_upsample=True`.
    `p` and `q` blocks run at 1/4 and 1/8."""

    def __init__(self, num_class: int = 1, p: int = 3, q: int = 9,
                 k: int = 4, act_type: str = 'relu', device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, 16, 3, 2, act_type=a, device=d)
        blocks = [(16, 16, 1, 1), (16, 32, k, 2)] + [(32, 32, k, 1)] * (p - 1) \
            + [(32, 64, k, 2)] + [(64, 64, k, 1)] * (q - 1)
        for i, (cin, c, e, s) in enumerate(blocks):
            setattr(self, f'FPEBlock_{i}', FPEBlock(cin, c, e, s, act_type=a,
                                                    device=d))
        self.stages = (1, 1 + p, 1 + p + q)
        self.MEUModule_0 = MEUModule(32, 64, 64, a, device=d)
        self.MEUModule_1 = MEUModule(16, 64, 32, a, device=d)
        self.ConvBNAct_1 = ConvBNAct(32, num_class, 1, act_type=a, device=d)

    def _blocks(self, x, first: int, last: int):
        for i in range(first, last):
            x = getattr(self, f'FPEBlock_{i}')(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        s1, s2, s3 = self.stages
        x1 = self._blocks(self.ConvBNAct_0(x), 0, s1)
        x2 = self._blocks(x1, s1, s2)
        x = self._blocks(x2, s2, s3)
        x = self.MEUModule_1(x1, self.MEUModule_0(x2, x))
        x = self.ConvBNAct_1(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
