"""ESNet (arXiv:1906.09826), the port of rtseg_tpu/models/esnet.py.

A symmetric encoder-decoder: ENet initial blocks to 1/2, 1/4 and 1/8 with
factorized convolution units (FCU, kernel K) and parallel factorized
dilated units (PFCU, rates 2, 5 and 9) between them, and transposed-conv
DeConvBNActs back to full resolution, the last one to the classes (the
eval step takes the plain argmax; K1 is never launched). Submodules carry
the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, Conv, ConvBNAct, DeConvBNAct
from .ddrnet import _Scope
from .enet import InitialBlock


class FCU(nn.Module):
    """(K,1) conv, act, (1,K) ConvBNAct, (K,1) conv, act, (1,K) ConvBN,
    the residual, act. One activation module serves all three, as in the
    JAX unit (one PReLU slope under act_type 'prelu')."""

    def __init__(self, channels: int, K: int, act_type: str = 'relu',
                 device=None):
        super().__init__()
        c, d = channels, device
        self.Activation_0 = Activation(act_type, d)
        self.Conv_0 = Conv(c, c, (K, 1), device=d)
        self.ConvBNAct_0 = ConvBNAct(c, c, (1, K), act_type=act_type,
                                     device=d)
        self.Conv_1 = Conv(c, c, (K, 1), device=d)
        self.ConvBNAct_1 = ConvBNAct(c, c, (1, K), act_type='none', device=d)

    def forward(self, x):
        act = self.Activation_0
        y = self.ConvBNAct_0(act(self.Conv_0(x)))
        y = self.ConvBNAct_1(act(self.Conv_1(y)))
        return act(y + x)


class PFCU(nn.Module):
    """A factorized 3x3 pair, then one dilated factorized pair a rate,
    summed with the residual; one shared activation module."""

    def __init__(self, channels: int, rates=(2, 5, 9), act_type: str = 'relu',
                 device=None):
        super().__init__()
        c, d = channels, device
        self.n = len(rates)
        self.Activation_0 = Activation(act_type, d)
        self.Conv_0 = Conv(c, c, (3, 1), device=d)
        self.ConvBNAct_0 = ConvBNAct(c, c, (1, 3), act_type=act_type,
                                     device=d)
        for i, r in enumerate(rates, 1):
            setattr(self, f'Conv_{i}', Conv(c, c, (3, 1), dilation=r,
                                            device=d))
            setattr(self, f'ConvBNAct_{i}', ConvBNAct(
                c, c, (1, 3), dilation=r, act_type='none', device=d))

    def forward(self, x):
        act = self.Activation_0
        y = self.ConvBNAct_0(act(self.Conv_0(x)))
        out = None
        for i in range(1, self.n + 1):
            z = act(getattr(self, f'Conv_{i}')(y))
            z = getattr(self, f'ConvBNAct_{i}')(z)
            out = z if out is None else out + z
        return act(out + x)


class ESNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full size (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.InitialBlock_0 = InitialBlock(3, 16, a, device=d)
        self.InitialBlock_1 = InitialBlock(16, 64, a, device=d)
        self.InitialBlock_2 = InitialBlock(64, 128, a, device=d)
        self.DeConvBNAct_0 = DeConvBNAct(128, 64, act_type=a, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(64, 16, act_type=a, device=d)
        self.DeConvBNAct_2 = DeConvBNAct(16, num_class, act_type=a, device=d)
        scope = _Scope(self)
        fcu = [scope.add(FCU(c, k, a, device=d))
               for c, k in [(16, 3)] * 3 + [(64, 5)] * 2 + [(64, 5)] * 2
               + [(16, 3)] * 2]
        pfcu = [scope.add(PFCU(128, (2, 5, 9), a, device=d))
                for _ in range(3)]
        # the stages between the blocks: (block, units after it)
        self.stages = (('InitialBlock_0', fcu[0:3]),
                       ('InitialBlock_1', fcu[3:5]),
                       ('InitialBlock_2', pfcu),
                       ('DeConvBNAct_0', fcu[5:7]),
                       ('DeConvBNAct_1', fcu[7:9]),
                       ('DeConvBNAct_2', []))

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        for block, units in self.stages:
            x = getattr(self, block)(x)
            for name in units:
                x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1)
