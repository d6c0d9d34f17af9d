"""ERFNet (IEEE 8063438), the port of rtseg_tpu/models/erfnet.py.

ENet initial blocks to 1/2, 1/4 and 1/8 with non-bottleneck-1D units
(factorized (3,1)/(1,3) conv pairs, the second pair dilated, the residual
added before the last BatchNorm and activation), and a decoder of
transposed-conv DeConvBNActs back to full resolution, the last one to the
classes: the logits come at full size, so the eval step takes the plain
argmax and the fused head (K1) is never launched. Submodules carry the
Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, BatchNorm, Conv, ConvBNAct, DeConvBNAct
from .ddrnet import _Scope
from .enet import InitialBlock


class NonBt1DBlock(nn.Module):
    """Its three ConvBNActs use ReLU whatever act_type, as the JAX block
    does; the activation after the residual takes act_type."""

    def __init__(self, channels: int, dilation: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, d = channels, device
        self.ConvBNAct_0 = ConvBNAct(c, c, (3, 1), device=d)
        self.ConvBNAct_1 = ConvBNAct(c, c, (1, 3), device=d)
        self.ConvBNAct_2 = ConvBNAct(c, c, (3, 1), dilation=dilation, device=d)
        self.Conv_0 = Conv(c, c, (1, 3), dilation=dilation, device=d)
        self.BatchNorm_0 = BatchNorm(c, d)
        self.Activation_0 = Activation(act_type, d)

    def forward(self, x):
        y = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        return self.Activation_0(self.BatchNorm_0(self.Conv_0(y) + x))


class ERFNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full size (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.InitialBlock_0 = InitialBlock(3, 16, a, device=d)
        self.InitialBlock_1 = InitialBlock(16, 64, a, device=d)
        self.InitialBlock_2 = InitialBlock(64, 128, a, device=d)
        blocks = [(64, 1)] * 5 + [(128, r) for r in (2, 4, 8, 16) * 2] + \
            [(64, 1)] * 2 + [(16, 1)] * 2
        scope = _Scope(self)
        self.blocks = [scope.add(NonBt1DBlock(c, r, a, device=d))
                       for c, r in blocks]
        self.DeConvBNAct_0 = DeConvBNAct(128, 64, act_type=a, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(64, 16, act_type=a, device=d)
        self.DeConvBNAct_2 = DeConvBNAct(16, num_class, act_type=a, device=d)

    def _blocks(self, x, first: int, last: int):
        for name in self.blocks[first:last]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = self.InitialBlock_1(self.InitialBlock_0(x))
        x = self._blocks(x, 0, 5)
        x = self._blocks(self.InitialBlock_2(x), 5, 13)
        x = self._blocks(self.DeConvBNAct_0(x), 13, 15)
        x = self._blocks(self.DeConvBNAct_1(x), 15, 17)
        return self.DeConvBNAct_2(x).permute(0, 2, 3, 1)
