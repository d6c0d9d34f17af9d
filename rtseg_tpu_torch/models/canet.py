"""CANet (arXiv:1907.10958), the port of rtseg_tpu/models/canet.py.

A spatial branch (three stride-2 ConvBNActs to 1/8), a context branch (a
MobileNetV2 or ResNet, its 1/32 features through a 2x transposed conv,
concatenated with its 1/16 features and through another), the feature
cross attention module (a spatial gate from the spatial branch, a channel
gate from the context branch's max and average through the shared `ca_fc`
Dense) and an 8x transposed conv (kernel 15) to full-resolution logits.
The model has no final upsample and `defer_upsample` changes nothing: the
eval step takes its identity-size argmax.

Flax's Dense promotes its bf16 input to its float32 parameters, so with
bf16 activations the channel gate, and with it everything after the
gating product, runs in float32, as here: `ca_fc` computes in float32
(`nn/modules.py::dense`) and the product of a bf16 map with the float32
gate is float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import ConvBNAct, DeConvBNAct, dense
from ..ops.pool import adaptive_max_pool_nchw, global_avg_pool_nchw
from .backbone import build_backbone


class SpatialBranch(nn.Module):
    def __init__(self, channels: int = 64, act_type: str = 'relu',
                 device=None):
        super().__init__()
        c, a, d = channels, act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, c, 3, 2, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(c, c * 2, 3, 2, act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(c * 2, c * 4, 3, 2, act_type=a,
                                     device=d)

    def forward(self, x):
        return self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))


class ContextBranch(nn.Module):
    def __init__(self, out_channels: int, backbone_type: str = 'mobilenet_v2',
                 hid_channels: int = 192, device=None):
        super().__init__()
        if 'mobilenet' in backbone_type:
            backbone_type = 'mobilenet_v2'
        self.backbone = build_backbone(backbone_type, device)
        _, _, c3, c4 = self.backbone.channels
        self.DeConvBNAct_0 = DeConvBNAct(c4, hid_channels, device=device)
        self.DeConvBNAct_1 = DeConvBNAct(hid_channels + c3, out_channels,
                                         device=device)

    def forward(self, x):
        _, _, x_d16, x = self.backbone(x)
        x = torch.cat([self.DeConvBNAct_0(x), x_d16], dim=1)
        return self.DeConvBNAct_1(x)


class FeatureCrossAttentionModule(nn.Module):
    def __init__(self, spatial_channels: int, context_channels: int,
                 out_channels: int, act_type: str = 'relu', device=None):
        super().__init__()
        c, a, d = spatial_channels, act_type, device
        self.ConvBNAct_0 = ConvBNAct(c, 1, act_type='sigmoid', device=d)
        self.ca_fc = nn.Linear(context_channels, c, device=d)
        self.ConvBNAct_1 = ConvBNAct(c + context_channels, c, act_type=a,
                                     device=d)
        self.ConvBNAct_2 = ConvBNAct(c, out_channels, device=d)

    def forward(self, x_s, x_c):
        sa = self.ConvBNAct_0(x_s)
        g_max = dense(adaptive_max_pool_nchw(x_c, 1).flatten(1), self.ca_fc)
        g_avg = dense(global_avg_pool_nchw(x_c).flatten(1), self.ca_fc)
        ca = torch.sigmoid(g_max + g_avg)[:, :, None, None]
        x = self.ConvBNAct_1(torch.cat([x_s, x_c], dim=1))
        return self.ConvBNAct_2(x * sa * ca + x)


class CANet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full resolution (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1,
                 backbone_type: str = 'mobilenet_v2', act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.SpatialBranch_0 = SpatialBranch(64, a, device=d)
        self.ContextBranch_0 = ContextBranch(256, backbone_type, device=d)
        self.FeatureCrossAttentionModule_0 = FeatureCrossAttentionModule(
            256, 256, num_class, a, device=d)
        self.DeConvBNAct_0 = DeConvBNAct(num_class, num_class, 8, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = self.FeatureCrossAttentionModule_0(self.SpatialBranch_0(x),
                                               self.ContextBranch_0(x))
        return self.DeConvBNAct_0(x).permute(0, 2, 3, 1)
