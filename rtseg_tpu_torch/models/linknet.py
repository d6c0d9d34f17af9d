"""LinkNet (arXiv:1707.03718), the port of rtseg_tpu/models/linknet.py.

A ResNet encoder, bottleneck decoder blocks (1x1, a 2x transposed conv or
a 3x3, 1x1) with additive skips, and a head of a transposed conv, a 3x3
ConvBNAct and a transposed conv to the classes. The head's transposed
convs bring the logits to full resolution, so the model has no final
upsample and `defer_upsample` changes nothing: the eval step takes its
identity-size argmax.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import ConvBNAct, DeConvBNAct
from .backbone import ResNet


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', scale_factor: int = 2, device=None):
        super().__init__()
        hid, a, d = in_channels // 4, act_type, device
        self.ConvBNAct_0 = ConvBNAct(in_channels, hid, 1, act_type=a,
                                     device=d)
        if scale_factor > 1:
            self.DeConvBNAct_0 = DeConvBNAct(hid, hid, scale_factor,
                                             act_type=a, device=d)
            self.names = ('ConvBNAct_0', 'DeConvBNAct_0', 'ConvBNAct_1')
        else:
            self.ConvBNAct_1 = ConvBNAct(hid, hid, 3, act_type=a, device=d)
            self.names = ('ConvBNAct_0', 'ConvBNAct_1', 'ConvBNAct_2')
        setattr(self, self.names[2], ConvBNAct(hid, out_channels, 1,
                                               act_type=a, device=d))

    def forward(self, x):
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class LinkNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full resolution (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, backbone_type: str = 'resnet18',
                 act_type: str = 'relu', device=None):
        super().__init__()
        if 'resnet' not in backbone_type:
            raise NotImplementedError()
        a, d = act_type, device
        self.backbone = ResNet(backbone_type, device=d)
        c1, c2, c3, c4 = self.backbone.channels
        ch0 = 64 if backbone_type in ('resnet18', 'resnet34') else 256
        self.DecoderBlock_0 = DecoderBlock(c4, c3, a, device=d)
        self.DecoderBlock_1 = DecoderBlock(c3, c2, a, device=d)
        self.DecoderBlock_2 = DecoderBlock(c2, c1, a, device=d)
        self.DecoderBlock_3 = DecoderBlock(c1, ch0, a, scale_factor=1,
                                           device=d)
        hid = ch0 // 2
        self.DeConvBNAct_0 = DeConvBNAct(ch0, hid, act_type=a, device=d)
        self.ConvBNAct_0 = ConvBNAct(hid, hid, 3, act_type=a, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(hid, num_class, act_type=a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x1, x2, x3, x4 = self.backbone(x)
        x = self.DecoderBlock_0(x4)
        x = self.DecoderBlock_1(x + x3)
        x = self.DecoderBlock_2(x + x2)
        x = self.DecoderBlock_3(x + x1)
        x = self.DeConvBNAct_1(self.ConvBNAct_0(self.DeConvBNAct_0(x)))
        return x.permute(0, 2, 3, 1)
