"""CFPNet (arXiv:2103.12212), the port of rtseg_tpu/models/cfpnet.py.

Three ConvBNActs to 1/2, then ENet initial blocks to 1/4 and 1/8, each
stage followed by channel-wise feature pyramid modules (CFP: K = 4
parallel ladders of asymmetric (3,1)/(1,3) dilated convs, each ladder
summed onto the previous one) and concatenated with the input image
resized to its resolution; a 1x1 ConvBNAct to the classes at 1/8 and the
final align-corners upsample. Submodules carry the Flax scope names.
"""

from __future__ import annotations

from math import ceil
from typing import Sequence

import torch
import torch.nn as nn

from ..nn import ConvBNAct
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .enet import InitialBlock


class FeaturePyramidChannel(nn.Module):
    """Three (3,1) then (1,3) dilated ConvBNAct pairs in a ladder, their
    outputs concatenated: `channels` split 1:1:2."""

    def __init__(self, channels: int, dilation: int,
                 act_type: str = 'prelu',
                 channel_split: Sequence[int] = (1, 1, 2), device=None):
        super().__init__()
        split_num = sum(channel_split)
        if channels % split_num != 0:
            raise ValueError(f'Channel of FPC should be multiple of '
                             f'{split_num}.')
        unit = channels // split_num
        in_c = channels
        for i, s in enumerate(channel_split):
            c = unit * s
            setattr(self, f'ConvBNAct_{2 * i}', ConvBNAct(
                in_c, c, (3, 1), dilation=dilation, act_type=act_type,
                device=device))
            setattr(self, f'ConvBNAct_{2 * i + 1}', ConvBNAct(
                c, c, (1, 3), dilation=dilation, act_type=act_type,
                device=device))
            in_c = c
        self.n = len(channel_split)

    def forward(self, x):
        outs = []
        for i in range(self.n):
            x = getattr(self, f'ConvBNAct_{2 * i + 1}')(
                getattr(self, f'ConvBNAct_{2 * i}')(x))
            outs.append(x)
        return torch.cat(outs, dim=1)


class CFPModule(nn.Module):
    def __init__(self, channels: int, rk: int, K: int = 4,
                 act_type: str = 'prelu', device=None):
        super().__init__()
        a, d = act_type, device
        ratios = (1 / rk, 1 / 4, 1 / 2, 1)
        ch_kn = channels // K
        self.K = K
        self.ConvBNAct_0 = ConvBNAct(channels, ch_kn, 1, act_type=a, device=d)
        for k in range(K):
            setattr(self, f'FeaturePyramidChannel_{k}', FeaturePyramidChannel(
                ch_kn, ceil(rk * ratios[k]), a, device=d))
        self.ConvBNAct_1 = ConvBNAct(ch_kn * K, channels, 1, act_type=a,
                                     device=d)

    def forward(self, x):
        y = self.ConvBNAct_0(x)
        feats = []
        for k in range(self.K):
            z = getattr(self, f'FeaturePyramidChannel_{k}')(y)
            if k > 0:
                z = z + feats[-1]
            feats.append(z)
        return self.ConvBNAct_1(torch.cat(feats, dim=1)) + x


class CFPNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`.
    `n` and `m` CFP modules follow the 1/4 and 1/8 blocks, with
    `dilations` (n + m of them)."""

    def __init__(self, num_class: int = 1, n: int = 2, m: int = 6,
                 dilations: Sequence[int] = (2, 2, 4, 4, 8, 8, 16, 16),
                 act_type: str = 'prelu', device=None):
        super().__init__()
        if len(dilations) != n + m:
            raise ValueError(f'{len(dilations)} dilations for {n} + {m} '
                             f'CFP modules')
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(32, 32, 3, act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(32, 32, 3, act_type=a, device=d)
        self.InitialBlock_0 = InitialBlock(32 + 3, 64, a, device=d)
        self.InitialBlock_1 = InitialBlock(64 + 3, 128, a, device=d)
        self.stages = ([f'CFPModule_{i}' for i in range(n)],
                       [f'CFPModule_{i}' for i in range(n, n + m)])
        for i, rk in enumerate(dilations):
            setattr(self, f'CFPModule_{i}',
                    CFPModule(64 if i < n else 128, rk, act_type=a, device=d))
        self.ConvBNAct_3 = ConvBNAct(128 + 3, num_class, 1, act_type=a,
                                     device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        inj = [resize_bilinear_nchw(x, (size[0] // s, size[1] // s),
                                    align_corners=True) for s in (2, 4, 8)]
        x = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        x = torch.cat([x, inj[0]], dim=1)
        for block, names, img in ((self.InitialBlock_0, self.stages[0],
                                   inj[1]),
                                  (self.InitialBlock_1, self.stages[1],
                                   inj[2])):
            x = block(x)
            for name in names:
                x = getattr(self, name)(x)
            x = torch.cat([x, img], dim=1)
        x = self.ConvBNAct_3(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
