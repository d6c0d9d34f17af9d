"""BiSeNet V1 (arXiv:1808.00897), the port of rtseg_tpu/models/bisenetv1.py.

A spatial path (three stride-2 convs to 1/8, 128 channels), a ResNet
context path whose 1/16 and 1/32 features are refined by attention
refinement modules and merged upward, the feature fusion module, SegHead at
1/8 and the final align-corners upsample. The attention refinement and
feature fusion modules are shared with STDC.

Both modules gate a feature map with channel attention computed from its
global average. The JAX modules broadcast the pooled map back to full size
before their 1x1 convs; these run the convs on the pooled [B, C, 1, 1] map
and broadcast in the product, which gives the same values: a 1x1 conv is
pointwise, and a BatchNorm over a broadcast map sees each sample's value
H*W times, so its mean and biased variance are those of the B pooled
values. The pooled form sums in another order; it holds STDC's Flax twin
within 1e-4 over three float32 training steps
(tests/test_torch_zoo_train.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, SegHead
from ..ops.pool import global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .backbone import ResNet


class AttentionRefinementModule(nn.Module):
    """x * sigmoid(ConvBN(global average of x))."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(channels, channels, 1,
                                     act_type='sigmoid', device=device)

    def forward(self, x):
        return x * self.ConvBNAct_0(global_avg_pool_nchw(x))


class FeatureFusionModule(nn.Module):
    """concat -> 3x3 ConvBNAct -> x + x * sigmoid(att2(relu(att1(global
    average))))."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels, 3,
                                     act_type=act_type, device=device)
        self.att1 = Conv(out_channels, out_channels, 1, device=device)
        self.att2 = Conv(out_channels, out_channels, 1, device=device)

    def forward(self, x_low, x_high):
        x = self.ConvBNAct_0(torch.cat([x_low, x_high], dim=1))
        gate = torch.relu(self.att1(global_avg_pool_nchw(x)))
        return x + x * torch.sigmoid(self.att2(gate))


class SpatialPath(nn.Module):
    """Three 3x3 stride-2 ConvBNActs to 1/8."""

    def __init__(self, out_channels: int = 128, act_type: str = 'relu',
                 device=None):
        super().__init__()
        c = out_channels
        self.ConvBNAct_0 = ConvBNAct(3, c, 3, 2, act_type=act_type,
                                     device=device)
        self.ConvBNAct_1 = ConvBNAct(c, c, 3, 2, act_type=act_type,
                                     device=device)
        self.ConvBNAct_2 = ConvBNAct(c, c, 3, 2, act_type=act_type,
                                     device=device)

    def forward(self, x):
        return self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))


class ContextPath(nn.Module):
    """ResNet to 1/32; the refined 1/32 features plus their global average
    through a 1x1 conv, upsampled onto the refined 1/16 features through
    theirs, and the sum upsampled to 1/8."""

    def __init__(self, out_channels: int = 256,
                 backbone_type: str = 'resnet18', device=None):
        super().__init__()
        if 'resnet' not in backbone_type:
            raise NotImplementedError()
        self.backbone = ResNet(backbone_type, device=device)
        c16, c32 = self.backbone.channels[2:]
        self.arm_32 = AttentionRefinementModule(c32, device=device)
        self.conv_32 = Conv(c32, out_channels, 1, device=device)
        self.arm_16 = AttentionRefinementModule(c16, device=device)
        self.conv_16 = Conv(c16, out_channels, 1, device=device)

    def forward(self, x):
        _, _, x_16, x_32 = self.backbone(x)
        x_32 = self.conv_32(self.arm_32(x_32) + global_avg_pool_nchw(x_32))
        x_32 = resize_bilinear_nchw(x_32, x_16.shape[2:4], align_corners=True)
        x_16 = self.conv_16(self.arm_16(x_16)) + x_32
        return resize_bilinear_nchw(
            x_16, (x_16.shape[2] * 2, x_16.shape[3] * 2), align_corners=True)


class BiSeNetv1(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, backbone_type: str = 'resnet18',
                 act_type: str = 'relu', device=None):
        super().__init__()
        a, d = act_type, device
        self.SpatialPath_0 = SpatialPath(128, a, device=d)
        self.ContextPath_0 = ContextPath(256, backbone_type, device=d)
        self.FeatureFusionModule_0 = FeatureFusionModule(128 + 256, 256, a,
                                                         device=d)
        self.SegHead_0 = SegHead(256, num_class, a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = self.FeatureFusionModule_0(self.SpatialPath_0(x),
                                       self.ContextPath_0(x))
        x = self.SegHead_0(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
