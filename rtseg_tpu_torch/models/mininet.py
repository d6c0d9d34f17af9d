"""MiniNet (IEEE 8793923), the port of rtseg_tpu/models/mininet.py.

A ladder of depth-wise separable downsamplings to 1/64, two branches of
dilated depth-wise conv modules (bare convs and the activation, no
BatchNorm, with dropout 0.25), and a ladder of DeConvBNActs that
concatenates each encoder output back, the last one to the classes at
full size: the eval step takes the plain argmax and K1 is never launched.
Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import (Activation, Conv, DeConvBNAct, Dropout, DSConvBNAct,
                  conv1x1)
from .ddrnet import _Scope


class ConvModule(nn.Module):
    """Factorized depth-wise convs (1x3, 3x1, 3x1, 1x3 at one dilation),
    the second's output added back, dropout 0.25, the input added back."""

    def __init__(self, channels: int, dilation: int, act_type: str = 'selu',
                 device=None):
        super().__init__()
        c, r, d = channels, dilation, device
        self.Activation_0 = Activation(act_type, d)
        for i, k in enumerate(((1, 3), (3, 1), (3, 1), (1, 3))):
            setattr(self, f'Conv_{i}', Conv(c, c, k, dilation=r, groups=c,
                                            device=d))
        self.Dropout_0 = Dropout(0.25)

    def forward(self, x):
        act = self.Activation_0
        x1 = act(self.Conv_1(act(self.Conv_0(x))))
        y = self.Conv_3(act(self.Conv_2(x1))) + x1
        return act(self.Dropout_0(y) + x)


class MiniNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] (H, W multiples of 64) and returns
    NHWC class logits [B, H, W, C] at full size (also with
    `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, act_type: str = 'selu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        scope = _Scope(self)
        ds = [scope.add(DSConvBNAct(cin, cout, 3, 2, act_type=a, device=d))
              for cin, cout in ((3, 12), (12, 24), (24, 48), (48, 96),
                                (96, 192), (192, 386))]
        self.down, (self.down5, self.down6) = ds[:4], ds[4:]
        cm = [scope.add(ConvModule(c, r, a, device=d))
              for c, r in ((96, 1), (96, 2), (96, 4), (96, 8), (192, 1),
                           (386, 1), (386, 1), (192, 1), (96, 1))]
        self.branch1, self.branch2, self.head_cm = cm[:4], cm[4:8], cm[8]
        self.up = [scope.add(DeConvBNAct(cin, cout, act_type=a, device=d))
                   for cin, cout in ((386, 192), (384, 96), (288, 96),
                                     (96, 24), (48, 12), (24, num_class))]
        self.Conv_0 = conv1x1(96, 48, device=d)

    def _run(self, x, names):
        for name in names:
            x = getattr(self, name)(x)
        return x

    def _ladder(self, x):
        outs = []
        for name in self.down:
            x = getattr(self, name)(x)
            outs.append(x)
        return outs

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_d1, x_d2, x_d3, x_d4 = self._ladder(x)
        x_b1 = self._run(x_d4, self.branch1)
        x_d5 = getattr(self, self.down5)(x_d4)
        cm = self.branch2
        x_b2 = getattr(self, cm[0])(x_d5)
        x_b2 = self._run(getattr(self, self.down6)(x_b2), cm[1:3])
        up = [getattr(self, n) for n in self.up]
        x_b2 = getattr(self, cm[3])(up[0](x_b2))
        x_b2 = up[1](torch.cat([x_b2, x_d5], dim=1))
        x = up[2](torch.cat([x_b1, x_b2, x_d4], dim=1))
        x = self.Conv_0(getattr(self, self.head_cm)(x))
        x = up[3](torch.cat([x, x_d3], dim=1))
        x = up[4](torch.cat([x, x_d2], dim=1))
        x = up[5](torch.cat([x, x_d1], dim=1))
        return x.permute(0, 2, 3, 1)

