"""RegSeg (arXiv:2111.09957), the port of rtseg_tpu/models/regseg.py.

RegNet-style dilated blocks (DBlock): a 1x1 ConvBNAct; at stride 1 the
channels split in two halves, each through a grouped 3x3 ConvBNAct
(groups = half // 16) of its own dilation, concatenated; at stride 2 one
grouped strided 3x3 ConvBNAct, with an avg_pool(2,2) and 1x1 ConvBN
shortcut. Then a squeeze-and-excitation gate (two Dense layers, the
activation between them and a sigmoid, over the channel means), a 1x1
ConvBN, the shortcut added and the activation. The encoder runs 13
dilation pairs at 1/16 and ends at 1/32; the decoder merges 1/32, 1/16
and 1/4 (align-corners upsamples), and a 1x1 conv gives the logits at
1/4, before the final align-corners upsample. The JAX build departs from
the reference, which cannot be constructed (rtseg_tpu/models/regseg.py
says why); this is the JAX build. Submodules carry the Flax scope names.

Flax's Dense promotes its bf16 input to its float32 parameters, so with
bf16 activations everything after the first block's gating product runs
in float32, as here (models/cgnet.py says how); the logits come out
float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, Conv, ConvBNAct, dense
from ..ops.pool import avg_pool_nchw, global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw

DEFAULT_DILATIONS = ((1, 1), (1, 2), (1, 2), (1, 3), (2, 3), (2, 7), (2, 3),
                     (2, 6), (2, 5), (2, 9), (2, 11), (4, 7), (5, 14))


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction_ratio: float = 0.25,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, sq = channels, int(channels * reduction_ratio)
        self.Dense_0 = nn.Linear(c, sq, device=device)
        self.Activation_0 = Activation(act_type, device)
        self.Dense_1 = nn.Linear(sq, c, device=device)

    def forward(self, x):
        g = self.Activation_0(dense(global_avg_pool_nchw(x).flatten(1),
                                    self.Dense_0))
        g = dense(g, self.Dense_1)
        return x * torch.sigmoid(g)[:, :, None, None]


class DBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 r1: int = 1, r2: int = 1, g: int = 16,
                 se_ratio: float = 0.25, act_type: str = 'relu',
                 device=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f'Unsupported stride: {stride}')
        c, a, d = out_channels, act_type, device
        self.stride = stride
        self.ConvBNAct_0 = ConvBNAct(in_channels, c, 1, act_type=a, device=d)
        if stride == 1:
            if in_channels != c:
                raise ValueError(f'a stride-1 DBlock keeps its width: '
                                 f'{in_channels} -> {c}')
            self.split = split = c // 2
            self.ConvBNAct_1 = ConvBNAct(split, split, 3, dilation=r1,
                                         groups=split // g, act_type=a,
                                         device=d)
            self.ConvBNAct_2 = ConvBNAct(c - split, split, 3, dilation=r2,
                                         groups=split // g, act_type=a,
                                         device=d)
        else:
            self.ConvBNAct_1 = ConvBNAct(c, c, 3, 2, groups=c // g,
                                         act_type=a, device=d)
            self.ConvBNAct_2 = ConvBNAct(in_channels, c, 1, act_type='none',
                                         device=d)
        self.SEBlock_0 = SEBlock(c, se_ratio, a, device=d)
        self.ConvBNAct_3 = ConvBNAct(c, c, 1, act_type='none', device=d)
        self.Activation_0 = Activation(a, d)

    def forward(self, x):
        residual = x
        x = self.ConvBNAct_0(x)
        if self.stride == 1:
            s = self.split
            x = torch.cat([self.ConvBNAct_1(x[:, :s]),
                           self.ConvBNAct_2(x[:, s:])], dim=1)
        else:
            x = self.ConvBNAct_1(x)
            residual = self.ConvBNAct_2(avg_pool_nchw(residual, 2, 2, 0))
        x = self.ConvBNAct_3(self.SEBlock_0(x))
        return self.Activation_0(x + residual)


class Decoder(nn.Module):
    def __init__(self, num_class: int, d4_channels: int = 48,
                 d8_channels: int = 128, d16_channels: int = 320,
                 act_type: str = 'relu', device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(d16_channels, 128, 1, act_type=a,
                                     device=d)
        self.ConvBNAct_1 = ConvBNAct(d8_channels, 128, 1, act_type=a,
                                     device=d)
        self.ConvBNAct_2 = ConvBNAct(128, 64, 3, act_type=a, device=d)
        self.ConvBNAct_3 = ConvBNAct(d4_channels, 8, 1, act_type=a, device=d)
        self.ConvBNAct_4 = ConvBNAct(72, 64, 3, act_type=a, device=d)
        self.Conv_0 = Conv(64, num_class, 1, device=d)

    def forward(self, x_d4, x_d8, x_d16):
        d16 = resize_bilinear_nchw(self.ConvBNAct_0(x_d16), x_d8.shape[2:4],
                                   align_corners=True)
        d8 = self.ConvBNAct_2(self.ConvBNAct_1(x_d8) + d16)
        d8 = resize_bilinear_nchw(d8, x_d4.shape[2:4], align_corners=True)
        x = torch.cat([self.ConvBNAct_3(x_d4), d8], dim=1)
        return self.Conv_0(self.ConvBNAct_4(x))


class RegSeg(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/4-resolution logits with `defer_upsample=True`.
    `dilations` holds the 13 (r1, r2) pairs of the 1/16 stage and its
    strided last block."""

    def __init__(self, num_class: int = 1, dilations=DEFAULT_DILATIONS,
                 act_type: str = 'relu', device=None):
        super().__init__()
        if len(dilations) != 13:
            raise ValueError("Dilation pairs' length should be 13")
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        blocks = [(32, 48, 2, 1, 1), (48, 128, 2, 1, 1), (128, 128, 1, 1, 1),
                  (128, 128, 1, 1, 1), (128, 256, 2, 1, 1)] \
            + [(256, 256, 1, r1, r2) for r1, r2 in dilations[:-1]] \
            + [(256, 320, 2) + tuple(dilations[-1])]
        for i, (cin, c, s, r1, r2) in enumerate(blocks):
            setattr(self, f'DBlock_{i}', DBlock(cin, c, s, r1, r2, act_type=a,
                                                device=d))
        self.n = len(blocks)
        self.Decoder_0 = Decoder(num_class, act_type=a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = self.ConvBNAct_0(x)
        feats = []
        for i in range(self.n):
            x = getattr(self, f'DBlock_{i}')(x)
            feats.append(x)
        # 1/4 after block 0, 1/8 after block 3, 1/32 after the last
        x = self.Decoder_0(feats[0], feats[3], feats[-1])
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
