"""PP-LiteSeg (arXiv:2204.02681), the port of rtseg_tpu/models/pp_liteseg.py.

Its own STDC1 or STDC2 encoder (two strided ConvBNActs, then STDC modules
to 1/8, 1/16 and 1/32), the simple pyramid pooling module (SPPM: pooled
branches summed, then a 3x3 conv) on the 1/32 features, and a light
decoder that fuses each upsampled level with the next finer one by a
unified attention fusion module (UAFM: a spatial or channel gate), ending
at 1/8 in a ConvBNAct to the classes and the final align-corners upsample.
Submodules carry the Flax scope names of the JAX model.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct
from ..ops.pool import adaptive_avg_pool_nchw, adaptive_max_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .stdc import STDCModule

DECODER_CHANNEL_HUB = {'stdc1': (32, 64, 128), 'stdc2': (64, 96, 128)}
REPEAT_TIMES_HUB = {'stdc1': (1, 1, 1), 'stdc2': (3, 4, 2)}


class STDCBackbone(nn.Module):
    """Features at 1/8, 1/16 and 1/32. The JAX module creates every block
    inline on its own scope, so the STDC modules count on from
    `STDCModule_0` across the three stages."""

    def __init__(self, encoder_channels: Sequence[int],
                 encoder_type: str = 'stdc1', device=None):
        super().__init__()
        ec = tuple(encoder_channels)
        rep = REPEAT_TIMES_HUB[encoder_type]
        self.ConvBNAct_0 = ConvBNAct(3, ec[0], 3, 2, device=device)
        self.ConvBNAct_1 = ConvBNAct(ec[0], ec[1], 3, 2, device=device)
        self.stages, n, in_c = [], 0, ec[1]
        for c, r in zip(ec[2:], rep):
            names = []
            for i in range(r + 1):
                names.append(f'STDCModule_{n}')
                self.add_module(names[-1], STDCModule(
                    in_c, c, 2 if i == 0 else 1, device=device))
                n, in_c = n + 1, c
            self.stages.append(names)

    def forward(self, x):
        x = self.ConvBNAct_1(self.ConvBNAct_0(x))
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


class SPPM(nn.Module):
    POOL_SIZES = (1, 2, 4)

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        hid = in_channels // 4
        for i in range(len(self.POOL_SIZES)):
            setattr(self, f'pool{i + 1}', ConvBNAct(
                in_channels, hid, 1, act_type=act_type, device=device))
        self.Conv_0 = Conv(hid, out_channels, 3, device=device)

    def forward(self, x):
        size = x.shape[2:4]
        acc = None
        for i, ps in enumerate(self.POOL_SIZES):
            y = getattr(self, f'pool{i + 1}')(adaptive_avg_pool_nchw(x, ps))
            y = resize_bilinear_nchw(y, size, align_corners=True)
            acc = y if acc is None else acc + y
        return self.Conv_0(acc)


class UAFM(nn.Module):
    """alpha * up(x_high) + (1 - alpha) * conv1x1(x_low), alpha a sigmoid
    gate over the channel means and maxima of both (spatial fusion, one
    gate a pixel) or over their global means and maxima (channel fusion,
    one gate a channel). The maxima are `amax`, which splits the gradient
    evenly among equal maxima as JAX's `max` does."""

    def __init__(self, high_channels: int, low_channels: int,
                 out_channels: int, fusion_type: str = 'spatial',
                 device=None):
        super().__init__()
        if fusion_type not in ('spatial', 'channel'):
            raise ValueError(f'Unsupport fusion type: {fusion_type}.')
        self.spatial = fusion_type == 'spatial'
        self.Conv_0 = Conv(low_channels, out_channels, 1, device=device)
        if self.spatial:
            self.Conv_1 = Conv(4, 1, 1, device=device)
        else:
            self.Conv_1 = Conv(2 * (high_channels + out_channels),
                               out_channels, 1, device=device)

    def forward(self, x_high, x_low):
        x_low = self.Conv_0(x_low)
        x_up = resize_bilinear_nchw(x_high, x_low.shape[2:4],
                                    align_corners=True)
        if self.spatial:
            feats = [x_up.mean(1, keepdim=True), x_up.amax(1, keepdim=True),
                     x_low.mean(1, keepdim=True), x_low.amax(1, keepdim=True)]
        else:
            feats = [x_up.mean((2, 3), keepdim=True),
                     adaptive_max_pool_nchw(x_up, 1),
                     x_low.mean((2, 3), keepdim=True),
                     adaptive_max_pool_nchw(x_low, 1)]
        alpha = torch.sigmoid(self.Conv_1(torch.cat(feats, dim=1)))
        return alpha * x_up + (1 - alpha) * x_low


class PPLiteSeg(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`.
    """

    def __init__(self, num_class: int = 1,
                 encoder_channels: Sequence[int] = (32, 64, 256, 512, 1024),
                 encoder_type: str = 'stdc1', fusion_type: str = 'spatial',
                 act_type: str = 'relu', hires_remat: bool = False,
                 device=None):
        super().__init__()
        if encoder_type not in DECODER_CHANNEL_HUB:
            raise ValueError(f'Unsupport encoder type: {encoder_type}.')
        if hires_remat:
            raise NotImplementedError(
                'PPLiteSeg in the PyTorch port does not implement the TPU '
                'lever hires_remat (see ROADMAP.md); unset it')
        dc = DECODER_CHANNEL_HUB[encoder_type]
        ec = tuple(encoder_channels)
        a, d = act_type, device
        self.STDCBackbone_0 = STDCBackbone(ec, encoder_type, device=d)
        self.SPPM_0 = SPPM(ec[4], dc[0], a, device=d)
        self.ConvBNAct_0 = ConvBNAct(dc[0], dc[0], 3, device=d)
        self.UAFM_0 = UAFM(dc[0], ec[3], dc[0], fusion_type, device=d)
        self.ConvBNAct_1 = ConvBNAct(dc[0], dc[1], 3, device=d)
        self.UAFM_1 = UAFM(dc[1], ec[2], dc[1], fusion_type, device=d)
        self.ConvBNAct_2 = ConvBNAct(dc[1], dc[2], 3, device=d)
        self.ConvBNAct_3 = ConvBNAct(dc[2], num_class, 3, act_type=a,
                                     device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x3, x4, x5 = self.STDCBackbone_0(x)
        x = self.ConvBNAct_0(self.SPPM_0(x5))
        x = self.ConvBNAct_1(self.UAFM_0(x, x4))
        x = self.ConvBNAct_2(self.UAFM_1(x, x3))
        x = self.ConvBNAct_3(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
