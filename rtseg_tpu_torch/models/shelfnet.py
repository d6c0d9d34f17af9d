"""ShelfNet (arXiv:1811.11254), the port of rtseg_tpu/models/shelfnet.py.

A ResNet encoder with 1x1 lateral ConvBNActs to (32, 64, 128, 256)
channels, then a decoder, an encoder and a decoder of residual S-blocks
(the "shelf"), joined by transposed convs upward and strided convs
downward; a 1x1 conv to the classes at 1/4 and the final align-corners
upsample. Output stride 1/4.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..nn import Activation, Conv, ConvBNAct, DeConvBNAct
from ..ops.resize import final_upsample
from .backbone import ResNet


class SBlock(nn.Module):
    """(x_l + x_v) through two 3x3 ConvBNs, plus itself, activated."""

    def __init__(self, channels: int, act_type: str = 'relu', device=None):
        super().__init__()
        c, a = channels, act_type
        self.ConvBNAct_0 = ConvBNAct(c, c, 3, act_type=a, device=device)
        self.ConvBNAct_1 = ConvBNAct(c, c, 3, act_type='none', device=device)
        self.Activation_0 = Activation(a, device)

    def forward(self, x_l, x_v=0.):
        x = x_l + x_v
        return self.Activation_0(self.ConvBNAct_1(self.ConvBNAct_0(x)) + x)


class DecoderBlock(nn.Module):
    def __init__(self, channels: Sequence[int], act_type: str = 'relu',
                 device=None):
        super().__init__()
        ch, a, d = channels, act_type, device
        self.block_D = SBlock(ch[3], a, d)
        self.up_D = DeConvBNAct(ch[3], ch[2], act_type=a, device=d)
        self.block_C = SBlock(ch[2], a, d)
        self.up_C = DeConvBNAct(ch[2], ch[1], act_type=a, device=d)
        self.block_B = SBlock(ch[1], a, d)
        self.up_B = DeConvBNAct(ch[1], ch[0], act_type=a, device=d)
        self.block_A = SBlock(ch[0], a, d)

    def forward(self, x_a, x_b, x_c, x_d):
        x_d = self.block_D(x_d)
        x_c = self.block_C(x_c, self.up_D(x_d))
        x_b = self.block_B(x_b, self.up_C(x_c))
        x_a = self.block_A(x_a, self.up_B(x_b))
        return x_a, x_b, x_c


class EncoderBlock(nn.Module):
    def __init__(self, channels: Sequence[int], act_type: str = 'relu',
                 device=None):
        super().__init__()
        ch, a, d = channels, act_type, device
        self.block_A = SBlock(ch[0], a, d)
        self.down_A = ConvBNAct(ch[0], ch[1], 3, 2, act_type=a, device=d)
        self.block_B = SBlock(ch[1], a, d)
        self.down_B = ConvBNAct(ch[1], ch[2], 3, 2, act_type=a, device=d)
        self.block_C = SBlock(ch[2], a, d)
        self.down_C = ConvBNAct(ch[2], ch[3], 3, 2, act_type=a, device=d)

    def forward(self, x_a, x_b, x_c):
        x_a = self.block_A(x_a)
        x_b = self.block_B(x_b, self.down_A(x_a))
        x_c = self.block_C(x_c, self.down_B(x_b))
        return x_a, x_b, x_c, self.down_C(x_c)


class ShelfNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/4-resolution logits with `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, backbone_type: str = 'resnet18',
                 hid_channels: Sequence[int] = (32, 64, 128, 256),
                 act_type: str = 'relu', device=None):
        super().__init__()
        if 'resnet' not in backbone_type:
            raise NotImplementedError()
        hc, a, d = hid_channels, act_type, device
        self.backbone = ResNet(backbone_type, device=d)
        for i, (c_in, c) in enumerate(zip(self.backbone.channels, hc)):
            setattr(self, f'ConvBNAct_{i}',
                    ConvBNAct(c_in, c, 1, act_type=a, device=d))
        self.decoder2 = DecoderBlock(hc, a, d)
        self.encoder3 = EncoderBlock(hc, a, d)
        self.decoder4 = DecoderBlock(hc, a, d)
        self.Conv_0 = Conv(hc[0], num_class, 1, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        feats = [getattr(self, f'ConvBNAct_{i}')(f)
                 for i, f in enumerate(self.backbone(x))]
        x_a, x_b, x_c = self.decoder2(*feats)
        x_a, x_b, x_c, x_d = self.encoder3(x_a, x_b, x_c)
        x = self.Conv_0(self.decoder4(x_a, x_b, x_c, x_d)[0])
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
