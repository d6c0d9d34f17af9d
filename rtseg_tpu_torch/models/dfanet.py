"""DFANet (arXiv:1904.02216), the port of rtseg_tpu/models/dfanet.py.

A strided ConvBNAct to 1/2, then three cascaded Xception-A encoders
(`backbone1..3`): each runs three stages of Xception blocks (two
depth-wise separable ConvBNActs to a quarter of the width, a strided
depth-wise ConvBNAct back to it, a 1x1 conv and the activation, with a
strided 1x1 conv shortcut at a stage's first block and the input added
in the others) and an FC attention (an adaptive max pool to 1x1, a
Dense layer to 1000 features and a 1x1 ConvBNAct back to the channels,
multiplying the features). Each later encoder takes the previous one's
output upsampled 4x (align-corners) and concatenates each stage's input
with the previous encoder's output of that stage. The decoder sums 3x3
ConvBNActs of the three encoders' first stages (1/4, 1/8, 1/16) and
segmentation heads over their attention outputs (1/16, 1/32, 1/64), all
upsampled to 1/4 with align-corners, for the logits at 1/4, and the final
align-corners upsample closes the model. The input must divide by 64.
Submodules carry the Flax scope names.

Flax's Dense promotes its bf16 input to its float32 parameters, so with
bf16 activations everything after backbone1's attention product runs in
float32, as here (models/cgnet.py says how), while backbone1's stages and
the decoder's ConvBNAct over its first stage stay bf16; the logits come
out float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..nn import (Activation, Conv, ConvBNAct, DSConvBNAct, DWConvBNAct,
                  SegHead, dense)
from ..ops.pool import adaptive_max_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw


def _up(x, s: int):
    return resize_bilinear_nchw(x, (x.shape[2] * s, x.shape[3] * s),
                                align_corners=True)


class XceptionBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expansion: int = 4, act_type: str = 'relu', device=None):
        super().__init__()
        c, a, d = out_channels, act_type, device
        hid = c // expansion
        self.stride = stride
        self.use_skip = in_channels == c and stride == 1
        self.DSConvBNAct_0 = DSConvBNAct(in_channels, hid, 3, act_type=a,
                                         device=d)
        self.DSConvBNAct_1 = DSConvBNAct(hid, hid, 3, act_type=a, device=d)
        self.DWConvBNAct_0 = DWConvBNAct(hid, c, 3, stride, act_type=a,
                                         device=d)
        self.Conv_0 = Conv(c, c, 1, device=d)
        self.Activation_0 = Activation(a, d)
        if stride > 1:
            self.Conv_1 = Conv(in_channels, c, 1, 2, device=d)

    def forward(self, x):
        y = self.DWConvBNAct_0(self.DSConvBNAct_1(self.DSConvBNAct_0(x)))
        y = self.Activation_0(self.Conv_0(y))
        if self.stride > 1:
            y = y + self.Conv_1(x)
        if self.use_skip:
            y = y + x
        return y


class FCAttention(nn.Module):
    def __init__(self, channels: int, act_type: str = 'relu',
                 linear_channels: int = 1000, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, linear_channels, device=device)
        self.ConvBNAct_0 = ConvBNAct(linear_channels, channels, 1,
                                     act_type=act_type, device=device)

    def forward(self, x):
        att = dense(adaptive_max_pool_nchw(x, 1).flatten(1), self.Dense_0)
        return x * self.ConvBNAct_0(att[:, :, None, None])


class Encoder(nn.Module):
    """Three stages (`enc2`, `enc3`, `enc4`) and the FC attention. A
    cascaded encoder concatenates each stage's input with the previous
    encoder's output of that stage (`channels` more)."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 expansion: int = 4, repeat_times: Sequence[int] = (4, 6, 4),
                 act_type: str = 'relu', cascaded: bool = False,
                 device=None):
        super().__init__()
        self.stages = []
        cin = in_channels
        for stage, c, rep in zip(('enc2', 'enc3', 'enc4'), channels,
                                 repeat_times):
            cin += c * cascaded
            names = []
            for i in range(rep):
                names.append(f'{stage}_{i}')
                setattr(self, names[-1], XceptionBlock(
                    cin, c, 2 if i == 0 else 1, expansion, act_type,
                    device=device))
                cin = c
            self.stages.append(names)
        self.FCAttention_0 = FCAttention(cin, act_type, device=device)

    def forward(self, x, enc: Optional[Sequence[torch.Tensor]] = None):
        """Returns the attention output and each stage's output."""
        outs = []
        for k, names in enumerate(self.stages):
            if enc is not None:
                x = torch.cat([x, enc[k]], dim=1)
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return self.FCAttention_0(x), outs


class Decoder(nn.Module):
    def __init__(self, num_class: int, channels: Sequence[int],
                 act_type: str = 'relu', hid_channels: int = 48,
                 device=None):
        super().__init__()
        a, hid, d = act_type, hid_channels, device
        for i in range(3):
            setattr(self, f'ConvBNAct_{i}', ConvBNAct(channels[0], hid, 3,
                                                      act_type=a, device=d))
        self.Conv_0 = Conv(hid, num_class, 1, device=d)
        for i in range(3):
            setattr(self, f'SegHead_{i}', SegHead(channels[2], num_class, a,
                                                  device=d))

    def forward(self, enc, fc):
        e = [_up(getattr(self, f'ConvBNAct_{i}')(x), 2 ** i)
             for i, x in enumerate(enc)]
        y = self.Conv_0(e[0] + e[1] + e[2])
        for i, x in enumerate(fc):
            y = y + _up(getattr(self, f'SegHead_{i}')(x), 4 * 2 ** i)
        return y


class DFANet(nn.Module):
    """Takes NHWC images [B, H, W, 3], H and W multiples of 64, and
    returns NHWC class logits [B, H, W, C], or the 1/4-resolution logits
    with `defer_upsample=True` (1/16 without the extra backbones)."""

    def __init__(self, num_class: int = 1, backbone_type: str = 'XceptionA',
                 expansion: int = 4, repeat_times: Sequence[int] = (4, 6, 4),
                 use_extra_backbone: bool = True, act_type: str = 'relu',
                 device=None):
        super().__init__()
        if backbone_type == 'XceptionA':
            ch = (48, 96, 192)
        elif backbone_type == 'XceptionB':
            ch = (32, 64, 128)
        else:
            raise NotImplementedError()
        a, d = act_type, device
        self.use_extra_backbone = use_extra_backbone
        self.ConvBNAct_0 = ConvBNAct(3, 8, 3, 2, act_type=a, device=d)
        self.backbone1 = Encoder(8, ch, expansion, repeat_times, a,
                                 device=d)
        if not use_extra_backbone:
            self.SegHead_0 = SegHead(ch[2], num_class, a, device=d)
            return
        self.backbone2 = Encoder(ch[2], ch, expansion, repeat_times, a,
                                 cascaded=True, device=d)
        self.backbone3 = Encoder(ch[2], ch, expansion, repeat_times, a,
                                 cascaded=True, device=d)
        self.Decoder_0 = Decoder(num_class, ch, a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x, enc = self.backbone1(self.ConvBNAct_0(x))
        if not self.use_extra_backbone:
            x = self.SegHead_0(x)
            size = (x.shape[2] * 16, x.shape[3] * 16)
            return final_upsample(x, size, defer=defer_upsample).permute(
                0, 2, 3, 1)
        firsts, fc = [enc[0]], [x]
        for backbone in (self.backbone2, self.backbone3):
            x, enc = backbone(_up(x, 4), enc)
            firsts.append(enc[0])
            fc.append(x)
        y = self.Decoder_0(firsts, fc)
        size = (y.shape[2] * 4, y.shape[3] * 4)
        return final_upsample(y, size, defer=defer_upsample).permute(0, 2, 3, 1)
