"""AGLNet (S1568494620306207), the port of rtseg_tpu/models/aglnet.py.

LEDNet's encoder (ENet's initial block as the downsampling unit, SSnbt
units) to 1/8, the feature-attention pyramid module with a global-pool
residual (FAPM), two gated attention upsample modules (GAUM) back to 1/4
and 1/2 with the encoder's 1/4 and 1/2 outputs as skips, and a bias-free
1x1 conv to the classes at 1/2, then the final align-corners upsample
(deferred for the fused head, K1, at output stride 2). Submodules carry
the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn import Activation, BatchNorm, Conv, ConvBNAct
from ..ops.pool import global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .lednet import run_stage, ssnbt_encoder


class PyramidFeatureAttention(nn.Module):
    """One-channel asymmetric ConvBNActs: 1x7 stride 2 (then 7x1 beside),
    1x5 stride 2 (then 5x1 beside), 1x3 stride 2 and 3x1, summed coarse to
    fine through align-corners upsamples back to the input's size."""

    def __init__(self, in_channels: int, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        for i, (cin, k, stride) in enumerate((
                (in_channels, (1, 7), 2), (1, (7, 1), 1), (1, (1, 5), 2),
                (1, (5, 1), 1), (1, (1, 3), 2), (1, (3, 1), 1))):
            setattr(self, f'ConvBNAct_{i}', ConvBNAct(cin, 1, k, stride,
                                                      act_type=a, device=d))

    def forward(self, x):
        size0 = x.shape[2:4]
        x = self.ConvBNAct_0(x)
        size1 = x.shape[2:4]
        x1 = self.ConvBNAct_1(x)
        x = self.ConvBNAct_2(x)
        size2 = x.shape[2:4]
        x2 = self.ConvBNAct_3(x)
        x = self.ConvBNAct_5(self.ConvBNAct_4(x))
        x = resize_bilinear_nchw(x, size2, align_corners=True) + x2
        x = resize_bilinear_nchw(x, size1, align_corners=True) + x1
        return resize_bilinear_nchw(x, size0, align_corners=True)


class FAPM(nn.Module):
    """x times a 1x1 conv of the pyramid attention, plus the upsampled 1x1
    conv of x's global average."""

    def __init__(self, channels: int, act_type: str = 'relu', device=None):
        super().__init__()
        c, d = channels, device
        self.PyramidFeatureAttention_0 = PyramidFeatureAttention(c, act_type,
                                                                 device=d)
        self.Conv_0 = Conv(1, c, 1, device=d)
        self.Conv_1 = Conv(c, c, 1, device=d)

    def forward(self, x):
        pfa = self.Conv_0(self.PyramidFeatureAttention_0(x))
        gp = self.Conv_1(global_avg_pool_nchw(x))
        gp = resize_bilinear_nchw(gp, x.shape[2:4], align_corners=True)
        return x * pfa + gp


class GAUM(nn.Module):
    """The skip features gated by a sigmoid 1x1 conv (`sab`); the deep
    features upsampled 2x by a biased bare transposed conv (`up_conv`: k3,
    s2, padding 1, output padding 1), BN and the activation; their product
    gated by a sigmoid 1x1 conv (`cab`) of its global average, times
    itself, plus the upsampled features."""

    def __init__(self, high_channels: int, low_channels: int,
                 out_channels: int, act_type: str = 'relu', device=None):
        super().__init__()
        d = device
        self.sab = Conv(low_channels, 1, 1, device=d)
        self.up_conv = nn.ConvTranspose2d(high_channels, low_channels, 3,
                                          stride=2, padding=1,
                                          output_padding=1, bias=True,
                                          device=d)
        self.BatchNorm_0 = BatchNorm(low_channels, d)
        self.Activation_0 = Activation(act_type, d)
        self.cab = Conv(low_channels, out_channels, 1, device=d)

    def forward(self, x_high, x_low):
        x_low = x_low * torch.sigmoid(self.sab(x_low))
        u = self.up_conv
        y = F.conv_transpose2d(x_high, u.weight.to(x_high.dtype),
                               u.bias.to(x_high.dtype), u.stride, u.padding,
                               u.output_padding)
        y = self.Activation_0(self.BatchNorm_0(y))
        skip = y
        y = y * x_low
        skip2 = y
        y = y * torch.sigmoid(self.cab(global_avg_pool_nchw(y)))
        return y * skip2 + skip


class AGLNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] (H, W multiples of 64) and returns
    NHWC class logits [B, H, W, C], or the 1/2-resolution logits with
    `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.stages = ssnbt_encoder(self, a, d)
        self.FAPM_0 = FAPM(128, a, device=d)
        self.GAUM_0 = GAUM(128, 64, 64, a, device=d)
        self.GAUM_1 = GAUM(64, 32, 32, a, device=d)
        self.Conv_0 = Conv(32, num_class, 1, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_s1 = run_stage(self, self.stages[0], x)
        x_s2 = run_stage(self, self.stages[1], x_s1)
        x = self.FAPM_0(run_stage(self, self.stages[2], x_s2))
        x = self.GAUM_1(self.GAUM_0(x, x_s2), x_s1)
        x = self.Conv_0(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3,
                                                                     1)
