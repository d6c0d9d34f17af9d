"""FDDWNet (arXiv:1911.00632), the port of rtseg_tpu/models/fddwnet.py.

ENet initial blocks to 1/2, 1/4 and 1/8 with factorized dilated
depth-wise units (EERM) between them, the 1/4 features kept and added
back before the decoder's second transposed conv, and DeConvBNActs back to
full resolution, the last one to the classes (the eval step takes the
plain argmax; K1 is never launched). Submodules carry the Flax scope
names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, ConvBNAct, DeConvBNAct, DWConvBNAct
from .ddrnet import _Scope
from .enet import InitialBlock


class EERMUnit(nn.Module):
    """Two factorized depth-wise pairs ((k,1) then (1,k), the second pair
    dilated), each followed by a 1x1 ConvBNAct, the residual, act."""

    def __init__(self, channels: int, ks: int = 3, dilation: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, k, d = channels, ks, device
        self.DWConvBNAct_0 = DWConvBNAct(c, c, (k, 1), act_type='none',
                                         device=d)
        self.DWConvBNAct_1 = DWConvBNAct(c, c, (1, k), act_type='none',
                                         device=d)
        self.ConvBNAct_0 = ConvBNAct(c, c, 1, act_type=act_type, device=d)
        self.DWConvBNAct_2 = DWConvBNAct(c, c, (k, 1), dilation=dilation,
                                         act_type='none', device=d)
        self.DWConvBNAct_3 = DWConvBNAct(c, c, (1, k), dilation=dilation,
                                         act_type='none', device=d)
        self.ConvBNAct_1 = ConvBNAct(c, c, 1, act_type='none', device=d)
        self.Activation_0 = Activation(act_type, d)

    def forward(self, x):
        y = self.ConvBNAct_0(self.DWConvBNAct_1(self.DWConvBNAct_0(x)))
        y = self.ConvBNAct_1(self.DWConvBNAct_3(self.DWConvBNAct_2(y)))
        return self.Activation_0(y + x)


class FDDWNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full size (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, ks: int = 3,
                 act_type: str = 'relu', device=None):
        super().__init__()
        a, d = act_type, device
        self.InitialBlock_0 = InitialBlock(3, 16, a, device=d)
        self.InitialBlock_1 = InitialBlock(16, 64, a, device=d)
        self.InitialBlock_2 = InitialBlock(64, 128, a, device=d)
        self.DeConvBNAct_0 = DeConvBNAct(128, 64, act_type=a, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(64, 16, act_type=a, device=d)
        self.DeConvBNAct_2 = DeConvBNAct(16, num_class, act_type=a, device=d)
        units = [(64, 1)] * 5 + [(128, r) for r in (1, 2, 5, 9) * 2] + \
            [(128, r) for r in (2, 5, 9, 17) * 2] + [(64, 1)] * 2 + \
            [(16, 1)] * 2
        scope = _Scope(self)
        self.units = [scope.add(EERMUnit(c, ks, r, a, device=d))
                      for c, r in units]

    def _units(self, x, first: int, last: int):
        for name in self.units[first:last]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = self.InitialBlock_1(self.InitialBlock_0(x))
        residual = self._units(x, 0, 5)
        x = self._units(self.InitialBlock_2(residual), 5, 21)
        x = self._units(self.DeConvBNAct_0(x), 21, 23) + residual
        x = self._units(self.DeConvBNAct_1(x), 23, 25)
        return self.DeConvBNAct_2(x).permute(0, 2, 3, 1)
