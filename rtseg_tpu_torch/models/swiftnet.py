"""SwiftNet (arXiv:1903.08469), the port of rtseg_tpu/models/swiftnet.py.

A ResNet or MobileNetV2 encoder, 1x1 lateral ConvBNActs to a common width,
the pyramid pooling module (with a bias) on the deepest features and an
additive-skip upsampling decoder to 1/4, then the final align-corners
upsample.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import ConvBNAct, PyramidPoolingModule
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .backbone import build_backbone


class SwiftNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/4-resolution logits with `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, backbone_type: str = 'resnet18',
                 up_channels: int = 128, act_type: str = 'relu',
                 device=None):
        super().__init__()
        c, a, d = up_channels, act_type, device
        self.backbone = build_backbone(backbone_type, d)
        c1, c2, c3, c4 = self.backbone.channels
        self.ConvBNAct_0 = ConvBNAct(c1, c, 1, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(c2, c, 1, act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(c3, c, 1, act_type=a, device=d)
        self.PyramidPoolingModule_0 = PyramidPoolingModule(c4, c, a,
                                                           bias=True,
                                                           device=d)
        self.ConvBNAct_3 = ConvBNAct(c, c, 3, act_type=a, device=d)
        self.ConvBNAct_4 = ConvBNAct(c, c, 3, act_type=a, device=d)
        self.ConvBNAct_5 = ConvBNAct(c, num_class, 3, act_type=a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x1, x2, x3, x4 = self.backbone(x)
        x1 = self.ConvBNAct_0(x1)
        x2 = self.ConvBNAct_1(x2)
        x3 = self.ConvBNAct_2(x3)
        x = self.PyramidPoolingModule_0(x4)
        x = resize_bilinear_nchw(x, x3.shape[2:4], align_corners=True) + x3
        x = self.ConvBNAct_3(x)
        x = resize_bilinear_nchw(x, x2.shape[2:4], align_corners=True) + x2
        x = self.ConvBNAct_4(x)
        x = resize_bilinear_nchw(x, x1.shape[2:4], align_corners=True) + x1
        x = self.ConvBNAct_5(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
