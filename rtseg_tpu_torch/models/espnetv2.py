"""ESPNetv2 (arXiv:1811.11431), the port of rtseg_tpu/models/espnetv2.py.

EESP units: a grouped 1x1 reduction (`conv_init`, groups K = 4), K
depth-wise separable branches of dilation 2^k summed hierarchically,
concatenated, and a grouped 1x1 expansion (`conv_last`); the input added
at stride 1, and at stride 2 concatenated with its avg_pool(3,2,1) and
added to a projection of the input image average-pooled to the unit's
output scale (an avg_pool(3,2,1) pyramid of the image). A strided
ConvBNAct and two strided units reach 1/8, `alpha3` units run there, a
strided unit and `alpha4` units run at 1/16; the 1/16 features,
upsampled with align-corners and projected, are concatenated with the
1/8 ones, then a pyramid pooling module (with biased convs) and a
segmentation head give the logits at 1/8, and the final align-corners
upsample closes the model. Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, DSConvBNAct, PyramidPoolingModule, SegHead
from ..ops.pool import avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw


class EESPModule(nn.Module):
    def __init__(self, channels: int, K: int = 4, ks: int = 3,
                 stride: int = 1, act_type: str = 'prelu', device=None):
        super().__init__()
        if channels % K != 0:
            raise ValueError('Input channels should be integer multiples '
                             'of K.')
        c, ck, d = channels, channels // K, device
        self.K, self.use_skip = K, stride == 1
        self.conv_init = Conv(c, ck, 1, groups=K, device=d)
        for k in range(K):
            setattr(self, f'DSConvBNAct_{k}', DSConvBNAct(
                ck, ck, ks, stride, 2 ** k, act_type=act_type, device=d))
        self.conv_last = Conv(ck * K, c, 1, groups=K, device=d)
        if not self.use_skip:
            self.ConvBNAct_0 = ConvBNAct(3, 3, 3, device=d)
            self.Conv_0 = Conv(3, 2 * c, 1, device=d)

    def forward(self, x, img=None):
        if not self.use_skip and img is None:
            raise ValueError('Strided EESP unit needs downsampled image.')
        y = self.conv_init(x)
        feats = []
        for k in range(self.K):
            z = getattr(self, f'DSConvBNAct_{k}')(y)
            if k > 0:
                z = z + feats[-1]
            feats.append(z)
        y = self.conv_last(torch.cat(feats, dim=1))
        if self.use_skip:
            return y + x
        y = torch.cat([y, avg_pool_nchw(x, 3, 2, 1)], dim=1)
        return y + self.Conv_0(self.ConvBNAct_0(img))


class ESPNetv2(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, K: int = 4, alpha3: int = 3,
                 alpha4: int = 7, act_type: str = 'prelu', device=None):
        super().__init__()
        a, d = act_type, device
        self.alpha3, self.alpha4 = alpha3, alpha4
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        units = [(32, 2), (64, 2)] + [(128, 1)] * alpha3 + [(128, 2)] \
            + [(256, 1)] * alpha4
        for i, (c, s) in enumerate(units):
            setattr(self, f'EESPModule_{i}', EESPModule(c, K, stride=s,
                                                        act_type=a, device=d))
        self.ConvBNAct_1 = ConvBNAct(256, 128, 1, device=d)
        self.PyramidPoolingModule_0 = PyramidPoolingModule(256, 256, a,
                                                           bias=True,
                                                           device=d)
        self.SegHead_0 = SegHead(256, num_class, a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_d2 = avg_pool_nchw(x, 3, 2, 1)
        x_d4 = avg_pool_nchw(x_d2, 3, 2, 1)
        x_d8 = avg_pool_nchw(x_d4, 3, 2, 1)
        x_d16 = avg_pool_nchw(x_d8, 3, 2, 1)
        x = self.ConvBNAct_0(x)
        x = self.EESPModule_0(x, x_d4)
        x = self.EESPModule_1(x, x_d8)
        n = 2 + self.alpha3
        for i in range(2, n):
            x = getattr(self, f'EESPModule_{i}')(x)
        x3 = x
        x = getattr(self, f'EESPModule_{n}')(x3, x_d16)
        for i in range(n + 1, n + 1 + self.alpha4):
            x = getattr(self, f'EESPModule_{i}')(x)
        x = resize_bilinear_nchw(x, x3.shape[2:4], align_corners=True)
        x = torch.cat([self.ConvBNAct_1(x), x3], dim=1)
        x = self.SegHead_0(self.PyramidPoolingModule_0(x))
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
