"""EDANet (arXiv:1809.06323), the port of rtseg_tpu/models/edanet.py.

Two downsampling blocks (a strided 3x3 conv beside a 2x2 max pool,
concatenated, then BatchNorm and the activation over the concatenation)
to 1/4, five dense EDA modules (a 1x1 ConvBNAct, then (3,1)/(1,3) conv
pairs, the second pair dilated, each output concatenated with the
module's input: 40 more channels a module), a strided ConvBNAct to 1/8,
eight more EDA modules, a 1x1 conv to the classes at 1/8 and the final
align-corners upsample. Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, BatchNorm, Conv, ConvBNAct
from ..ops.pool import max_pool_nchw
from ..ops.resize import final_upsample


class DownsamplingBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels - in_channels, 3, 2,
                           device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, x):
        x = torch.cat([self.Conv_0(x), max_pool_nchw(x, 2, 2)], dim=1)
        return self.Activation_0(self.BatchNorm_0(x))


class EDAModule(nn.Module):
    """The module's first 1x1 ConvBNAct takes ReLU whatever `act_type`, as
    in the JAX module."""

    def __init__(self, in_channels: int, k: int, dilation: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        a, r, d = act_type, dilation, device
        self.ConvBNAct_0 = ConvBNAct(in_channels, k, 1, device=d)
        self.Conv_0 = Conv(k, k, (3, 1), device=d)
        self.ConvBNAct_1 = ConvBNAct(k, k, (1, 3), act_type=a, device=d)
        self.Conv_1 = Conv(k, k, (3, 1), dilation=r, device=d)
        self.ConvBNAct_2 = ConvBNAct(k, k, (1, 3), dilation=r, act_type=a,
                                     device=d)

    def forward(self, x):
        y = self.ConvBNAct_1(self.Conv_0(self.ConvBNAct_0(x)))
        y = self.ConvBNAct_2(self.Conv_1(y))
        return torch.cat([y, x], dim=1)


class EDANet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`.
    The module counts (5 and 8) and their dilations are fixed, as in the
    JAX model, which takes `num_b1` and `num_b2` but reads neither."""

    STAGE1 = (1, 1, 1, 2, 2)
    STAGE2 = (2, 2, 4, 4, 8, 8, 16, 16)

    def __init__(self, num_class: int = 1, k: int = 40,
                 act_type: str = 'relu', device=None):
        super().__init__()
        a, d = act_type, device
        self.DownsamplingBlock_0 = DownsamplingBlock(3, 15, a, device=d)
        self.DownsamplingBlock_1 = DownsamplingBlock(15, 60, a, device=d)
        c = 60
        for i, r in enumerate(self.STAGE1):
            setattr(self, f'EDAModule_{i}', EDAModule(c, k, r, a, device=d))
            c += k
        self.ConvBNAct_0 = ConvBNAct(c, 130, 3, 2, act_type=a, device=d)
        c = 130
        for i, r in enumerate(self.STAGE2, len(self.STAGE1)):
            setattr(self, f'EDAModule_{i}', EDAModule(c, k, r, a, device=d))
            c += k
        self.Conv_0 = Conv(c, num_class, 1, device=d)

    def _modules_from(self, x, first: int, last: int):
        for i in range(first, last):
            x = getattr(self, f'EDAModule_{i}')(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = self.DownsamplingBlock_1(self.DownsamplingBlock_0(x))
        n1 = len(self.STAGE1)
        x = self.ConvBNAct_0(self._modules_from(x, 0, n1))
        x = self._modules_from(x, n1, n1 + len(self.STAGE2))
        x = self.Conv_0(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
