"""DABNet (arXiv:1907.11357), the port of rtseg_tpu/models/dabnet.py.

Three ConvBNActs to 1/2, an ENet initial block to 1/4 with three depth-wise
asymmetric bottleneck modules (DAB: a plain and a dilated branch of
depth-wise (3,1)/(1,3) ConvBNActs, summed), a strided ConvBNAct to 1/8
with six more, each stage concatenated with its input and with the image
average-pooled to its resolution (3x3, stride 2, padding 1, the padding
counted); a 1x1 conv to the classes at 1/8 and the final align-corners
upsample. Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, DWConvBNAct
from ..ops.pool import avg_pool_nchw
from ..ops.resize import final_upsample
from .enet import InitialBlock


class DABModule(nn.Module):
    def __init__(self, channels: int, dilation: int, act_type: str = 'prelu',
                 device=None):
        super().__init__()
        if channels % 2 != 0:
            raise ValueError('Input channel of DABModule should be multiple '
                             'of 2.')
        hid = channels // 2
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(channels, hid, 3, act_type=a, device=d)
        for i, (k, dil) in enumerate((((3, 1), 1), ((1, 3), 1),
                                      ((3, 1), dilation), ((1, 3), dilation))):
            setattr(self, f'DWConvBNAct_{i}', DWConvBNAct(
                hid, hid, k, dilation=dil, act_type=a, device=d))
        self.ConvBNAct_1 = ConvBNAct(hid, channels, 1, act_type=a, device=d)

    def forward(self, x):
        y = self.ConvBNAct_0(x)
        left = self.DWConvBNAct_1(self.DWConvBNAct_0(y))
        right = self.DWConvBNAct_3(self.DWConvBNAct_2(y))
        return self.ConvBNAct_1(left + right) + x


class DABNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`.
    """

    STAGE2_DILATIONS = (4, 4, 8, 8, 16, 16)

    def __init__(self, num_class: int = 1, act_type: str = 'prelu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(32, 32, 3, 1, act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(32, 32, 3, 1, act_type=a, device=d)
        self.InitialBlock_0 = InitialBlock(32 + 3, 64, a, device=d)
        for i in range(3):
            setattr(self, f'DABModule_{i}', DABModule(64, 2, a, device=d))
        self.ConvBNAct_3 = ConvBNAct(64 * 2 + 3, 128, 3, 2, act_type=a,
                                     device=d)
        for i, dil in enumerate(self.STAGE2_DILATIONS, 3):
            setattr(self, f'DABModule_{i}', DABModule(128, dil, a, device=d))
        self.Conv_0 = Conv(128 * 2 + 3, num_class, 1, device=d)

    def _modules_from(self, x, first: int, last: int):
        for i in range(first, last):
            x = getattr(self, f'DABModule_{i}')(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_d2 = avg_pool_nchw(x, 3, 2, 1)
        x_d4 = avg_pool_nchw(x_d2, 3, 2, 1)
        x_d8 = avg_pool_nchw(x_d4, 3, 2, 1)

        x = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        x = self.InitialBlock_0(torch.cat([x, x_d2], dim=1))
        block1 = x
        x = self._modules_from(x, 0, 3)
        x = self.ConvBNAct_3(torch.cat([x, block1, x_d4], dim=1))
        block2 = x
        x = self._modules_from(x, 3, 3 + len(self.STAGE2_DILATIONS))
        x = self.Conv_0(torch.cat([x, block2, x_d8], dim=1))
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
