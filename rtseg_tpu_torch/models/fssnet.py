"""FSSNet (IEEE 8392426), the port of rtseg_tpu/models/fssnet.py.

An ENet initial block to 1/2, two downsampling blocks (a max-pooled branch
summed with a strided bottleneck) to 1/4 and 1/8 with factorized and
dilated bottlenecks between them, upsampling blocks that add each
encoder's output back (a transposed-conv bottleneck summed with the
align-corners upsampled skip), and a DeConvBNAct to the classes at full
resolution (the eval step takes the plain argmax; K1 is never launched).
Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, ConvBNAct, DeConvBNAct
from ..ops.pool import max_pool_nchw
from ..ops.resize import resize_bilinear_nchw
from .ddrnet import _Scope
from .enet import InitialBlock


class FactorizedBlock(nn.Module):
    def __init__(self, channels: int, act_type: str = 'relu', device=None):
        super().__init__()
        c, hid, a, d = channels, channels // 4, act_type, device
        self.ConvBNAct_0 = ConvBNAct(c, hid, 1, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(hid, hid, (1, 3), act_type='none',
                                     device=d)
        self.ConvBNAct_2 = ConvBNAct(hid, hid, (3, 1), act_type=a, device=d)
        self.ConvBNAct_3 = ConvBNAct(hid, c, 1, act_type='none', device=d)
        self.Activation_0 = Activation(a, d)

    def forward(self, x):
        y = self.ConvBNAct_1(self.ConvBNAct_0(x))
        y = self.ConvBNAct_3(self.ConvBNAct_2(y))
        return self.Activation_0(y + x)


class DilatedBlock(nn.Module):
    def __init__(self, channels: int, dilation: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, hid, a, d = channels, channels // 4, act_type, device
        self.ConvBNAct_0 = ConvBNAct(c, hid, 1, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(hid, hid, 3, dilation=dilation,
                                     act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(hid, c, 1, act_type='none', device=d)
        self.Activation_0 = Activation(a, d)

    def forward(self, x):
        y = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        return self.Activation_0(y + x)


class DownsamplingBlock(nn.Module):
    """max_pool(3,2,1) then a 1x1 ConvBN, summed with a 2x2 stride-2
    bottleneck; the pool branch is created first, as in the JAX block."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'prelu', device=None):
        super().__init__()
        c, hid, a, d = out_channels, out_channels // 4, act_type, device
        self.ConvBNAct_0 = ConvBNAct(in_channels, c, 1, act_type='none',
                                     device=d)
        self.ConvBNAct_1 = ConvBNAct(in_channels, hid, 2, 2, act_type=a,
                                     device=d)
        self.ConvBNAct_2 = ConvBNAct(hid, hid, 3, act_type=a, device=d)
        self.ConvBNAct_3 = ConvBNAct(hid, c, 1, act_type='none', device=d)
        self.Activation_0 = Activation(a, d)

    def forward(self, x):
        p = self.ConvBNAct_0(max_pool_nchw(x, 3, 2, 1))
        y = self.ConvBNAct_3(self.ConvBNAct_2(self.ConvBNAct_1(x)))
        return self.Activation_0(y + p)


class UpsamplingBlock(nn.Module):
    """A bottleneck through a transposed conv (2x), summed with
    up2(conv1x1(x + skip))."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'prelu', device=None):
        super().__init__()
        hid, a, d = in_channels // 4, act_type, device
        self.ConvBNAct_0 = ConvBNAct(in_channels, hid, 1, act_type=a,
                                     device=d)
        self.DeConvBNAct_0 = DeConvBNAct(hid, hid, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(hid, out_channels, 1, act_type='none',
                                     device=d)
        self.ConvBNAct_2 = ConvBNAct(in_channels, out_channels, 1,
                                     act_type='none', device=d)
        self.Activation_0 = Activation(a, d)

    def forward(self, x, pool_feat):
        y = self.ConvBNAct_1(self.DeConvBNAct_0(self.ConvBNAct_0(x)))
        x = self.ConvBNAct_2(x + pool_feat)
        x = resize_bilinear_nchw(x, (x.shape[2] * 2, x.shape[3] * 2),
                                 align_corners=True)
        return self.Activation_0(x + y)


class FSSNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full size (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, act_type: str = 'prelu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.InitialBlock_0 = InitialBlock(3, 16, a, device=d)
        self.DownsamplingBlock_0 = DownsamplingBlock(16, 64, a, device=d)
        self.DownsamplingBlock_1 = DownsamplingBlock(64, 128, a, device=d)
        self.UpsamplingBlock_0 = UpsamplingBlock(128, 64, a, device=d)
        self.UpsamplingBlock_1 = UpsamplingBlock(64, 16, a, device=d)
        self.DeConvBNAct_0 = DeConvBNAct(16, num_class, act_type=a, device=d)
        scope = _Scope(self)
        self.factorized = [scope.add(FactorizedBlock(64, a, device=d))
                           for _ in range(4)]
        self.dilated = [scope.add(DilatedBlock(c, r, a, device=d))
                        for c, r in [(128, r) for r in (2, 5, 9, 2, 5, 9)]
                        + [(64, 1)] * 2 + [(16, 1)] * 2]

    def _run(self, x, names):
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_d1 = self.DownsamplingBlock_0(self.InitialBlock_0(x))
        x = self._run(x_d1, self.factorized)
        x_d2 = self.DownsamplingBlock_1(x)
        x = self._run(x_d2, self.dilated[:6])
        x = self._run(self.UpsamplingBlock_0(x, x_d2), self.dilated[6:8])
        x = self._run(self.UpsamplingBlock_1(x, x_d1), self.dilated[8:])
        return self.DeConvBNAct_0(x).permute(0, 2, 3, 1)
