"""LEDNet (arXiv:1905.02423), the port of rtseg_tpu/models/lednet.py.

ENet's initial block as the downsampling unit (to 1/2, 1/4, 1/8), split-
shuffle non-bottleneck (SSnbt) units between them (the channels split in
two, twin asymmetric-conv branches with biased bare convs, concatenated
and added back, then a channel shuffle of 2 groups), and the attention
pyramid head to the classes at 1/8, then the final align-corners upsample
(deferred for the fused head, K1). Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, Conv, ConvBNAct
from ..ops.pool import global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw
from ..ops.shuffle import channel_shuffle_nchw
from .ddrnet import _Scope
from .enet import InitialBlock


class SSnbtUnit(nn.Module):
    """Split-shuffle non-bottleneck unit on `channels` (even) channels:
    left half 3x1 -> 1x3 -> dilated 3x1 -> dilated 1x3, right half the
    transposed order; each first conv of a pair a biased bare conv and the
    activation, each second a ConvBNAct."""

    def __init__(self, channels: int, dilation: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        if channels % 2:
            raise ValueError('Input channel should be multiple of 2.')
        s, r, a, d = channels // 2, dilation, act_type, device
        self.Activation_0 = Activation(a, d)
        # (bare conv kernel, ConvBNAct kernel, dilation): left, then right
        pairs = [((3, 1), (1, 3), 1), ((3, 1), (1, 3), r),
                 ((1, 3), (3, 1), 1), ((1, 3), (3, 1), r)]
        for i, (kc, kb, dil) in enumerate(pairs):
            setattr(self, f'Conv_{i}', Conv(s, s, kc, dilation=dil,
                                            use_bias=True, device=d))
            setattr(self, f'ConvBNAct_{i}', ConvBNAct(s, s, kb, dilation=dil,
                                                      act_type=a, device=d))

    def _branch(self, x, first: int):
        for i in (first, first + 1):
            x = getattr(self, f'ConvBNAct_{i}')(
                self.Activation_0(getattr(self, f'Conv_{i}')(x)))
        return x

    def forward(self, x):
        s = x.shape[1] // 2
        y = torch.cat([self._branch(x[:, :s], 0), self._branch(x[:, s:], 2)],
                      dim=1)
        return channel_shuffle_nchw(self.Activation_0(x + y), 2)


class AttentionPyramidNetwork(nn.Module):
    """Three stride-2 3x3 ConvBNActs (1/2, 1/4, 1/8 of the input), each
    level to `out_channels`, summed coarse to fine through align-corners
    upsamples; times a 3x3 ConvBNAct of the input, plus the upsampled
    3x3 ConvBNAct of its global average."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        i, c, a, d = in_channels, out_channels, act_type, device
        for k, (cin, cout, stride) in enumerate(
                [(i, i, 2)] * 3 + [(i, c, 1)] * 5):
            setattr(self, f'ConvBNAct_{k}', ConvBNAct(cin, cout, 3, stride,
                                                      act_type=a, device=d))

    def forward(self, x):
        size0 = x.shape[2:4]
        l1 = self.ConvBNAct_0(x)
        l2 = self.ConvBNAct_1(l1)
        l3 = self.ConvBNAct_3(self.ConvBNAct_2(l2))
        l3 = resize_bilinear_nchw(l3, l2.shape[2:4], align_corners=True)
        l2 = resize_bilinear_nchw(self.ConvBNAct_4(l2) + l3, l1.shape[2:4],
                                  align_corners=True)
        l1 = resize_bilinear_nchw(self.ConvBNAct_5(l1) + l2, size0,
                                  align_corners=True)
        mid = l1 * self.ConvBNAct_6(x)
        right = self.ConvBNAct_7(global_avg_pool_nchw(x))
        return mid + resize_bilinear_nchw(right, size0, align_corners=True)


def ssnbt_encoder(owner: nn.Module, act_type: str = 'relu', device=None):
    """Register LEDNet's encoder on `owner` under the Flax scope names
    (InitialBlock_0..2, SSnbtUnit_0..12) and return its stages: [(the
    downsampling unit, [its SSnbt units])] at 1/2, 1/4 and 1/8. AGLNet
    shares it."""
    a, d = act_type, device
    scope = _Scope(owner)
    stages = []
    for cin, cout, dilations in ((3, 32, (1, 1, 1)), (32, 64, (1, 1)),
                                 (64, 128, (1, 2, 5, 9, 2, 5, 9, 17))):
        down = scope.add(InitialBlock(cin, cout, a, device=d))
        stages.append((down, [scope.add(SSnbtUnit(cout, r, a, device=d))
                              for r in dilations]))
    return stages


def run_stage(owner: nn.Module, stage, x):
    down, units = stage
    x = getattr(owner, down)(x)
    for name in units:
        x = getattr(owner, name)(x)
    return x


class LEDNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] (H, W multiples of 64) and returns
    NHWC class logits [B, H, W, C], or the 1/8-resolution logits with
    `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu',
                 device=None):
        super().__init__()
        self.stages = ssnbt_encoder(self, act_type, device)
        self.AttentionPyramidNetwork_0 = AttentionPyramidNetwork(
            128, num_class, act_type, device=device)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        for stage in self.stages:
            x = run_stage(self, stage, x)
        x = self.AttentionPyramidNetwork_0(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3,
                                                                     1)
