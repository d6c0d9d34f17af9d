"""Fast-SCNN (arXiv:1902.04502), the port of rtseg_tpu/models/fastscnn.py.

Learning-to-downsample (three stride-2 stages to 1/8), a global branch of
inverted residuals to 1/32 with a pyramid pooling module, feature fusion
at 1/8 (a bare BatchNorm over the sum of both branches), a DS-conv
classifier and the final align-corners upsample. Submodules carry the Flax
scope names of the JAX model. No aux heads: the training forward returns
the logits alone.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from ..nn import (Activation, BatchNorm, Conv, ConvBNAct, DSConvBNAct,
                  DWConvBNAct, PWConvBNAct, PyramidPoolingModule)
from ..ops.resize import final_upsample, resize_bilinear_nchw


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 expand_ratio: int = 6, act_type: str = 'relu', device=None):
        super().__init__()
        hid = int(round(in_channels * expand_ratio))
        self.use_res = stride == 1 and in_channels == out_channels
        self.PWConvBNAct_0 = PWConvBNAct(in_channels, hid, act_type,
                                         device=device)
        self.DWConvBNAct_0 = DWConvBNAct(hid, hid, 3, stride,
                                         act_type=act_type, device=device)
        self.ConvBNAct_0 = ConvBNAct(hid, out_channels, 1, act_type='none',
                                     device=device)

    def forward(self, x):
        y = self.ConvBNAct_0(self.DWConvBNAct_0(self.PWConvBNAct_0(x)))
        return x + y if self.use_res else y


class LearningToDownsample(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 64,
                 hid_channels: Sequence[int] = (32, 48),
                 act_type: str = 'relu', device=None):
        super().__init__()
        c0, c1 = hid_channels
        self.ConvBNAct_0 = ConvBNAct(in_channels, c0, 3, 2, act_type=act_type,
                                     device=device)
        self.DSConvBNAct_0 = DSConvBNAct(c0, c1, 3, 2, act_type=act_type,
                                         device=device)
        self.DSConvBNAct_1 = DSConvBNAct(c1, out_channels, 3, 2,
                                         act_type=act_type, device=device)

    def forward(self, x):
        return self.DSConvBNAct_1(self.DSConvBNAct_0(self.ConvBNAct_0(x)))


class GlobalFeatureExtractor(nn.Module):
    # (expand ratio, channels, repeats, first stride) of the three stages
    STAGES = ((6, 64, 3, 2), (6, 96, 2, 2), (6, 128, 3, 1))

    def __init__(self, in_channels: int = 64, out_channels: int = 128,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c_in, k = in_channels, 0
        for t, c, n, s in self.STAGES:
            for i in range(n):
                setattr(self, f'InvertedResidual_{k}',
                        InvertedResidual(c_in, c, s if i == 0 else 1, t,
                                         act_type, device=device))
                c_in, k = c, k + 1
        self.n = k
        self.PyramidPoolingModule_0 = PyramidPoolingModule(
            c_in, out_channels, act_type, bias=True, device=device)

    def forward(self, x):
        for k in range(self.n):
            x = getattr(self, f'InvertedResidual_{k}')(x)
        return self.PyramidPoolingModule_0(x)


class FeatureFusionModule(nn.Module):
    def __init__(self, higher_channels: int = 64, lower_channels: int = 128,
                 out_channels: int = 128, act_type: str = 'relu',
                 device=None):
        super().__init__()
        self.higher_res_conv = Conv(higher_channels, out_channels, 1,
                                    device=device)
        self.DWConvBNAct_0 = DWConvBNAct(lower_channels, lower_channels, 3, 1,
                                         act_type=act_type, device=device)
        self.lower_res_conv = Conv(lower_channels, out_channels, 1,
                                   device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, higher_res, lower_res):
        hi = self.higher_res_conv(higher_res)
        lo = resize_bilinear_nchw(lower_res, higher_res.shape[2:4],
                                  align_corners=True)
        lo = self.lower_res_conv(self.DWConvBNAct_0(lo))
        return self.Activation_0(self.BatchNorm_0(hi + lo))


class Classifier(nn.Module):
    def __init__(self, in_channels: int, num_class: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c = in_channels
        self.DSConvBNAct_0 = DSConvBNAct(c, c, 3, 1, act_type=act_type,
                                         device=device)
        self.DSConvBNAct_1 = DSConvBNAct(c, c, 3, 1, act_type=act_type,
                                         device=device)
        self.PWConvBNAct_0 = PWConvBNAct(c, num_class, act_type,
                                         device=device)

    def forward(self, x):
        return self.PWConvBNAct_0(self.DSConvBNAct_1(self.DSConvBNAct_0(x)))


class FastSCNN(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`
    (for the fused head, ops/fused_head.py)."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a = act_type
        self.LearningToDownsample_0 = LearningToDownsample(3, 64, (32, 48), a,
                                                           device=device)
        self.GlobalFeatureExtractor_0 = GlobalFeatureExtractor(64, 128, a,
                                                               device=device)
        self.FeatureFusionModule_0 = FeatureFusionModule(64, 128, 128, a,
                                                         device=device)
        self.Classifier_0 = Classifier(128, num_class, a, device=device)

    def forward(self, x, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        higher = self.LearningToDownsample_0(x)
        lower = self.GlobalFeatureExtractor_0(higher)
        x = self.Classifier_0(self.FeatureFusionModule_0(higher, lower))
        return final_upsample(x, size, defer=defer_upsample).permute(
            0, 2, 3, 1)
