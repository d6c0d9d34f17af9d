"""Lite-HRNet (arXiv:2104.06403), the port of rtseg_tpu/models/lite_hrnet.py.

A stem (a stride-2 ConvBNAct and a stride-2 shuffle block) to 1/4 and a
separable conv beside it to 1/8; three stages of parallel resolutions
(2, 3, then 4 branches, to 1/32), each module a cross-resolution weight
(`crw{i}`), conditional-channel-weight blocks on every branch
(`ccw{i}_{j}_{r}`) and a dense fusion (`fusion{i}`: `s2_up`, `s1_1`, ...),
the last module of the first two stages adding the next branch; the
branches upsampled to 1/4, concatenated, a separable conv and a 1x1 conv
to the classes, then the final align-corners upsample (deferred for the
fused head, K1, at 1/4). `ARCH_HUB` holds both published depths. Module
names are the Flax scope names, those the JAX model pins among them.
"""

from __future__ import annotations

import itertools
from typing import List

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, DSConvBNAct, DWConvBNAct
from ..ops.pool import adaptive_avg_pool_nchw, global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw, resize_nearest
from ..ops.shuffle import channel_shuffle_nchw
from .ddrnet import _Scope

# modules a stage: (stage 2, stage 3, stage 4)
ARCH_HUB = {'litehrnet18': (2, 4, 2), 'litehrnet30': (3, 8, 3)}


class ShuffleBlock(nn.Module):
    """The input's two channel halves: the left through a 1x1 ConvBNAct
    where the stride or the width changes, the right through 1x1, 3x3
    depth-wise (strided) and 1x1 ConvBNActs; concatenated and shuffled."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.in_l = in_l = in_channels // 2
        out_l = out_channels // 2
        out_r = out_channels - out_l
        a, d = act_type, device
        scope = _Scope(self)
        self.left = None
        if stride != 1 or in_l != out_l:
            self.left = scope.add(ConvBNAct(in_l, out_l, 1, stride,
                                            act_type=a, device=d))
        self.right = [scope.add(m) for m in (
            ConvBNAct(in_channels - in_l, out_r, 1, act_type=a, device=d),
            DWConvBNAct(out_r, out_r, 3, stride, act_type=a, device=d),
            ConvBNAct(out_r, out_r, 1, act_type=a, device=d))]

    def forward(self, x):
        xl, xr = x[:, :self.in_l], x[:, self.in_l:]
        if self.left is not None:
            xl = getattr(self, self.left)(xl)
        for name in self.right:
            xr = getattr(self, name)(xr)
        return channel_shuffle_nchw(torch.cat([xl, xr], dim=1), 2)


class SpatialWeightModule(nn.Module):
    """Sigmoid channel weights from the global average: 1x1 ConvBNActs
    to channels/8, then back (its BatchNorms see one value a sample and
    channel)."""

    def __init__(self, channels: int, act_type: str = 'relu',
                 ch_reduction: int = 8, device=None):
        super().__init__()
        c, hid = channels, channels // ch_reduction
        self.ConvBNAct_0 = ConvBNAct(c, hid, 1, act_type=act_type,
                                     device=device)
        self.ConvBNAct_1 = ConvBNAct(hid, c, 1, act_type='sigmoid',
                                     device=device)

    def forward(self, x):
        return self.ConvBNAct_1(self.ConvBNAct_0(global_avg_pool_nchw(x)))


class CCWBlock(nn.Module):
    """Conditional channel weighting: the left half kept, the right half
    times its nearest-upsampled cross-resolution weight, a 3x3 depth-wise
    ConvBNAct, times its spatial weights; concatenated and shuffled."""

    def __init__(self, channels: int, act_type: str = 'relu', device=None):
        super().__init__()
        self.in_l = channels // 2
        out_r = channels - self.in_l
        self.DWConvBNAct_0 = DWConvBNAct(out_r, out_r, 3, 1,
                                         act_type=act_type, device=device)
        self.SpatialWeightModule_0 = SpatialWeightModule(out_r, act_type,
                                                         device=device)

    def forward(self, x, cr_weight):
        xl, xr = x[:, :self.in_l], x[:, self.in_l:]
        w = resize_nearest(cr_weight.permute(0, 2, 3, 1),
                           xr.shape[2:4]).permute(0, 3, 1, 2)
        xr = self.DWConvBNAct_0(xr * w)
        xr = xr * self.SpatialWeightModule_0(xr)
        return channel_shuffle_nchw(torch.cat([xl, xr], dim=1), 2)


class CrossResolutionWeightModule(nn.Module):
    """The right halves of all branches, average-pooled to the coarsest
    branch's size and concatenated, through 1x1 ConvBNActs to a /8 width
    and back to the halves' widths (sigmoid), split per branch."""

    def __init__(self, channels: List[int], act_type: str = 'relu',
                 ch_reduction: int = 8, device=None):
        super().__init__()
        self.ch_r = [c // 2 for c in channels]
        total = sum(c - r for c, r in zip(channels, self.ch_r))
        hid = total // ch_reduction
        self.ConvBNAct_0 = ConvBNAct(total, hid, 1, act_type=act_type,
                                     device=device)
        self.ConvBNAct_1 = ConvBNAct(hid, sum(self.ch_r), 1,
                                     act_type='sigmoid', device=device)

    def forward(self, feats):
        pool_size = tuple(feats[-1].shape[2:4])
        parts = []
        for i, f in enumerate(feats):
            half = f[:, self.ch_r[i]:]
            if i < len(feats) - 1:
                half = adaptive_avg_pool_nchw(half, pool_size)
            parts.append(half)
        w = self.ConvBNAct_1(self.ConvBNAct_0(torch.cat(parts, dim=1)))
        splits = list(itertools.accumulate(self.ch_r))
        return [w[:, a:b] for a, b in zip([0] + splits[:-1], splits)]


class UpsampleBlock(nn.Module):
    """A 1x1 ConvBNAct, then an align-corners bilinear upsample by the
    scale factor."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int, act_type: str = 'relu', device=None):
        super().__init__()
        self.scale = scale_factor
        self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels, 1,
                                     act_type=act_type, device=device)

    def forward(self, x):
        x = self.ConvBNAct_0(x)
        s = self.scale
        return resize_bilinear_nchw(x, (x.shape[2] * s, x.shape[3] * s),
                                    align_corners=True)


class DownsampleBlock(nn.Module):
    """`num_block` stride-2 separable convs: the input's width until the
    last, which goes to `out_channels`."""

    def __init__(self, in_channels: int, out_channels: int, num_block: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.n = num_block
        for i in range(num_block):
            cout = out_channels if i == num_block - 1 else in_channels
            setattr(self, f'DSConvBNAct_{i}',
                    DSConvBNAct(in_channels, cout, 3, 2, act_type=act_type,
                                device=device))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'DSConvBNAct_{i}')(x)
        return x


class FusionBlock(nn.Module):
    """Every branch summed into every output resolution (upsampled by
    `UpsampleBlock`s, downsampled by `DownsampleBlock`s), with one more
    output, a resolution lower, where `extra_output`. Branch i has
    2^i * base_ch channels. The modules are the JAX block's, under its
    names."""

    def __init__(self, base_ch: int, stage: int, extra_output: bool,
                 act_type: str = 'relu', device=None):
        super().__init__()
        if stage not in (2, 3, 4):
            raise ValueError(f'FusionBlock stage {stage}')
        self.stage, self.extra = stage, extra_output
        c = [2 ** i * base_ch for i in range(stage + 1)]
        a, d = act_type, device

        def up(cin, cout, s):
            return UpsampleBlock(cin, cout, s, a, device=d)

        def down(cin, cout, n):
            return DownsampleBlock(cin, cout, n, a, device=d)

        self.s2_up = up(c[1], c[0], 2)
        self.s1_1 = down(c[0], c[1], 1)
        if stage in (3, 4) or extra_output:
            self.s1_2 = down(c[0], c[2], 2)
            self.s2_1 = down(c[1], c[2], 1)
        if stage in (3, 4):
            self.s3_up2 = up(c[2], c[0], 4)
            self.s3_up1 = up(c[2], c[1], 2)
            if stage == 4 or extra_output:
                self.s1_3 = down(c[0], c[3], 3)
                self.s2_2 = down(c[1], c[3], 2)
                self.s3_down = down(c[2], c[3], 1)
                if stage == 4:
                    self.s4_up3 = up(c[3], c[0], 8)
                    self.s4_up2 = up(c[3], c[1], 4)
                    self.s4_up1 = up(c[3], c[2], 2)

    def forward(self, feats):
        st = self.stage
        x3 = x4 = None
        x1 = feats[0] + self.s2_up(feats[1])
        x2 = self.s1_1(feats[0]) + feats[1]
        if st in (3, 4) or self.extra:
            x3 = self.s1_2(feats[0]) + self.s2_1(feats[1])
        if st in (3, 4):
            x1 = x1 + self.s3_up2(feats[2])
            x2 = x2 + self.s3_up1(feats[2])
            x3 = x3 + feats[2]
            if st == 4 or self.extra:
                x4 = (self.s1_3(feats[0]) + self.s2_2(feats[1])
                      + self.s3_down(feats[2]))
                if st == 4:
                    x1 = x1 + self.s4_up3(feats[3])
                    x2 = x2 + self.s4_up2(feats[3])
                    x3 = x3 + self.s4_up1(feats[3])
                    x4 = x4 + feats[3]
        return [x for x in (x1, x2, x3, x4) if x is not None]


class StageBlock(nn.Module):
    """`num_modules` modules on `stage` branches: `crw{i}`, then
    `ccw{i}_{j}_{r}` on branch j `repeat` times, then `fusion{i}`, whose
    last one adds a branch unless the stage is the fourth."""

    def __init__(self, base_ch: int, stage: int, repeat: int,
                 num_modules: int, act_type: str = 'relu', device=None):
        super().__init__()
        self.stage, self.repeat, self.num_modules = stage, repeat, num_modules
        chans = [2 ** j * base_ch for j in range(stage)]
        a, d = act_type, device
        for i in range(num_modules):
            setattr(self, f'crw{i}', CrossResolutionWeightModule(
                chans, a, device=d))
            for j in range(stage):
                for r in range(repeat):
                    setattr(self, f'ccw{i}_{j}_{r}',
                            CCWBlock(chans[j], a, device=d))
            extra = i == num_modules - 1 and stage != 4
            setattr(self, f'fusion{i}',
                    FusionBlock(base_ch, stage, extra, a, device=d))

    def forward(self, feats):
        feats = list(feats)
        for i in range(self.num_modules):
            cr_weight = getattr(self, f'crw{i}')(feats)
            for j in range(self.stage):
                for r in range(self.repeat):
                    feats[j] = getattr(self, f'ccw{i}_{j}_{r}')(
                        feats[j], cr_weight[j])
            feats = getattr(self, f'fusion{i}')(feats)
        return feats


class LiteHRNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] (H, W multiples of 32) and returns
    NHWC class logits [B, H, W, C], or the 1/4-resolution logits with
    `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, base_ch: int = 40,
                 arch_type: str = 'litehrnet18', repeat: int = 2,
                 act_type: str = 'relu', device=None):
        super().__init__()
        if arch_type not in ARCH_HUB:
            raise ValueError(f'Unsupport architecture type: {arch_type}.')
        nm = ARCH_HUB[arch_type]
        a, d, b = act_type, device, base_ch
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        self.ShuffleBlock_0 = ShuffleBlock(32, b, 2, a, device=d)
        self.DSConvBNAct_0 = DSConvBNAct(b, b * 2, 3, 2, act_type=a,
                                         device=d)
        for i, stage in enumerate((2, 3, 4)):
            setattr(self, f'StageBlock_{i}',
                    StageBlock(b, stage, repeat, nm[i], a, device=d))
        self.DSConvBNAct_1 = DSConvBNAct(b * 15, 128, 3, act_type=a,
                                         device=d)
        self.Conv_0 = Conv(128, num_class, 1, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = self.ShuffleBlock_0(self.ConvBNAct_0(x))
        feats = [x, self.DSConvBNAct_0(x)]
        for i in range(3):
            feats = getattr(self, f'StageBlock_{i}')(feats)
        top = feats[0].shape[2:4]
        x = torch.cat([feats[0]] + [resize_bilinear_nchw(f, top,
                                                         align_corners=True)
                                    for f in feats[1:]], dim=1)
        x = self.Conv_0(self.DSConvBNAct_1(x))
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3,
                                                                     1)
