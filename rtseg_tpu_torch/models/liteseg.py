"""LiteSeg (arXiv:1912.06683), the port of rtseg_tpu/models/liteseg.py.

A MobileNetV2 (or ResNet) encoder, the dense ASPP (a 1x1 branch, 3x3
branches of dilation 3, 6 and 9 and a global branch, concatenated with its
input) on the 1/32 features, upsampled and concatenated with the 1/8
features, a head of two 3x3 ConvBNActs and a 1x1 conv to the classes, and
the final align-corners upsample. Output stride 1/8.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct
from ..ops.pool import global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .backbone import build_backbone


class DASPPModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        hid = in_channels // 5
        last = in_channels - hid * 4
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(in_channels, hid, 1, act_type=a,
                                     device=d)
        for i, dil in enumerate((3, 6, 9), 1):
            setattr(self, f'ConvBNAct_{i}', ConvBNAct(
                in_channels, hid, 3, dilation=dil, act_type=a, device=d))
        self.Conv_0 = Conv(in_channels, last, 1, device=d)
        self.ConvBNAct_4 = ConvBNAct(in_channels * 2, out_channels, 1,
                                     act_type=a, device=d)

    def forward(self, x):
        feats = [x] + [getattr(self, f'ConvBNAct_{i}')(x) for i in range(4)]
        x5 = self.Conv_0(global_avg_pool_nchw(x))
        feats.append(resize_bilinear_nchw(x5, x.shape[2:4],
                                          align_corners=True))
        return self.ConvBNAct_4(torch.cat(feats, dim=1))


class LiteSeg(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`."""

    def __init__(self, num_class: int = 1,
                 backbone_type: str = 'mobilenet_v2', act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.backbone = build_backbone(backbone_type, d)
        _, c2, _, c4 = self.backbone.channels
        self.DASPPModule_0 = DASPPModule(c4, 512, a, device=d)
        self.ConvBNAct_0 = ConvBNAct(512 + c2, 256, 3, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(256, 128, 3, act_type=a, device=d)
        self.Conv_0 = Conv(128, num_class, 1, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        _, x1, _, x = self.backbone(x)
        x = self.DASPPModule_0(x)
        x = resize_bilinear_nchw(x, x1.shape[2:4], align_corners=True)
        x = self.ConvBNAct_0(torch.cat([x, x1], dim=1))
        x = self.Conv_0(self.ConvBNAct_1(x))
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
