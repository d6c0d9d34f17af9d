"""ContextNet (arXiv:1805.04554), the port of rtseg_tpu/models/contextnet.py.

Two branches: a shallow one at full input resolution (a strided
ConvBNAct, then three depth-wise (no activation) and point-wise ConvBNAct
pairs, to 1/2) and a deep one on the input resized to 1/4 with
align-corners (a strided ConvBNAct and MobileNetV2 inverted residuals, to
1/32). The feature fusion upsamples the deep branch to the shallow one's
size, runs a dilation-4 depth-wise separable conv and a 1x1 conv over it,
adds a 1x1 conv of the shallow branch and activates; a 1x1 ConvBNAct to
the classes at 1/2 and the final align-corners upsample close the model.
Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import (Activation, Conv, ConvBNAct, DSConvBNAct, DWConvBNAct,
                  PWConvBNAct)
from ..ops.resize import final_upsample, resize_bilinear_nchw


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 expand_ratio: int = 6, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        hid = int(round(in_channels * expand_ratio))
        self.use_res = stride == 1 and in_channels == out_channels
        self.PWConvBNAct_0 = PWConvBNAct(in_channels, hid, a, device=d)
        self.DWConvBNAct_0 = DWConvBNAct(hid, hid, 3, stride, act_type=a,
                                         device=d)
        self.ConvBNAct_0 = ConvBNAct(hid, out_channels, 1, act_type='none',
                                     device=d)

    def forward(self, x):
        y = self.ConvBNAct_0(self.DWConvBNAct_0(self.PWConvBNAct_0(x)))
        return x + y if self.use_res else y


class Branch1(nn.Module):
    def __init__(self, out_channels: int = 128, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        for i, (hid, nxt) in enumerate(((32, 64), (64, 128),
                                        (128, out_channels))):
            setattr(self, f'DWConvBNAct_{i}', DWConvBNAct(
                hid, hid, 3, 1, act_type='none', device=d))
            setattr(self, f'PWConvBNAct_{i}', PWConvBNAct(hid, nxt, a,
                                                          device=d))

    def forward(self, x):
        x = self.ConvBNAct_0(x)
        for i in range(3):
            x = getattr(self, f'PWConvBNAct_{i}')(
                getattr(self, f'DWConvBNAct_{i}')(x))
        return x


class Branch4(nn.Module):
    # (expand ratio t, channels c, blocks n, first stride s)
    SETTINGS = ((1, 32, 1, 1), (6, 32, 1, 1), (6, 48, 3, 2), (6, 64, 3, 2),
                (6, 96, 2, 1), (6, 128, 2, 1))

    def __init__(self, out_channels: int = 128, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        cin, i = 32, 0
        for t, c, n, s in self.SETTINGS:
            for j in range(n):
                setattr(self, f'InvertedResidual_{i}', InvertedResidual(
                    cin, c, s if j == 0 else 1, t, a, device=d))
                cin, i = c, i + 1
        self.n = i
        self.ConvBNAct_1 = ConvBNAct(cin, out_channels, 3, 1, act_type=a,
                                     device=d)

    def forward(self, x):
        x = self.ConvBNAct_0(x)
        for i in range(self.n):
            x = getattr(self, f'InvertedResidual_{i}')(x)
        return self.ConvBNAct_1(x)


class FeatureFusion(nn.Module):
    def __init__(self, channels: int = 128, out_channels: int = 128,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, d = out_channels, device
        self.branch_1_conv = Conv(channels, c, 1, device=d)
        self.DSConvBNAct_0 = DSConvBNAct(channels, c, 3, dilation=4,
                                         act_type='none', device=d)
        self.branch_4_conv = Conv(c, c, 1, device=d)
        self.Activation_0 = Activation(act_type, d)

    def forward(self, b1, b4):
        size = b1.shape[2:4]
        b1 = self.branch_1_conv(b1)
        b4 = resize_bilinear_nchw(b4, size, align_corners=True)
        b4 = self.branch_4_conv(self.DSConvBNAct_0(b4))
        return self.Activation_0(b1 + b4)


class ContextNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/2-resolution logits with `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.Branch1_0 = Branch1(128, a, device=d)
        self.Branch4_0 = Branch4(128, a, device=d)
        self.FeatureFusion_0 = FeatureFusion(128, 128, a, device=d)
        self.ConvBNAct_0 = ConvBNAct(128, num_class, 1, act_type=a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_low = resize_bilinear_nchw(x, (size[0] // 4, size[1] // 4),
                                     align_corners=True)
        x = self.FeatureFusion_0(self.Branch1_0(x), self.Branch4_0(x_low))
        x = self.ConvBNAct_0(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
