"""ESPNet (arXiv:1803.06815), the port of rtseg_tpu/models/espnet.py.

Efficient spatial pyramid (ESP) modules: a 1x1 reduction (strided where
the module downsamples), K = 5 dilated 3x3 ConvBNAct branches of
dilation 2^k summed hierarchically, concatenated, and the input added
where the shapes allow. Where the output width does not divide by K the
first branch takes the remainder and its own 1x1 reduction (`conv_k1`
beside `conv_kn`). Input reinforcement concatenates the image resized to
1/2 and 1/4 with align_corners=False (as the JAX model does) after the
stem and the 1/4 stage. The full 'espnet' variant decodes with three
transposed convs, two ESP modules over the concatenated encoder features
between them, to logits at full size (the eval step takes the plain
argmax; K1 is never launched); the -a, -b and -c variants end in a 1x1
conv at 1/8 and the final align-corners upsample. PReLU but where the JAX
model takes its ReLU defaults. Submodules carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, DeConvBNAct
from ..ops.resize import final_upsample, resize_bilinear_nchw


class ESPModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, K: int = 5,
                 ks: int = 3, stride: int = 1, act_type: str = 'prelu',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.K = K
        self.use_skip = in_channels == out_channels and stride == 1
        kn = out_channels // K
        k1 = out_channels - (K - 1) * kn
        self.split = k1 != kn
        if self.split:
            self.conv_k1 = Conv(in_channels, k1, 1, stride, device=d)
            self.conv_kn = Conv(in_channels, kn, 1, stride, device=d)
            self.ConvBNAct_0 = ConvBNAct(k1, k1, ks, 1, 1, act_type=a,
                                         device=d)
        else:
            self.Conv_0 = Conv(in_channels, kn, 1, stride, device=d)
            self.ConvBNAct_0 = ConvBNAct(kn, kn, ks, 1, 1, act_type=a,
                                         device=d)
        for k in range(1, K):
            setattr(self, f'ConvBNAct_{k}', ConvBNAct(
                kn, kn, ks, 1, 2 ** k, act_type=a, device=d))

    def forward(self, x):
        if self.split:
            feats = [self.ConvBNAct_0(self.conv_k1(x))]
            y = self.conv_kn(x)
            first = 2                   # the k1 branch is not summed on
        else:
            y = self.Conv_0(x)
            feats = [self.ConvBNAct_0(y)]
            first = 1
        for k in range(1, self.K):
            z = getattr(self, f'ConvBNAct_{k}')(y)
            if k >= first:
                z = z + feats[-1]
            feats.append(z)
        y = torch.cat(feats, dim=1)
        return y + x if self.use_skip else y


class Decoder(nn.Module):
    def __init__(self, num_class: int, l1_channels: int, l2_channels: int,
                 act_type: str = 'prelu', device=None):
        super().__init__()
        nc, a, d = num_class, act_type, device
        self.DeConvBNAct_0 = DeConvBNAct(nc, nc, act_type=a, device=d)
        self.ConvBNAct_0 = ConvBNAct(l2_channels, nc, 1, device=d)
        self.ESPModule_0 = ESPModule(2 * nc, nc, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(nc, nc, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(l1_channels, nc, 1, device=d)
        self.ESPModule_1 = ESPModule(2 * nc, nc, device=d)
        self.DeConvBNAct_2 = DeConvBNAct(nc, nc, device=d)

    def forward(self, x, x_l1, x_l2):
        x = self.DeConvBNAct_0(x)
        x = self.ESPModule_0(torch.cat([x, self.ConvBNAct_0(x_l2)], dim=1))
        x = self.DeConvBNAct_1(x)
        x = self.ESPModule_1(torch.cat([x, self.ConvBNAct_1(x_l1)], dim=1))
        return self.DeConvBNAct_2(x)


class ESPNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C]: at full size for 'espnet' (also with
    `defer_upsample=True`), or the 1/8-resolution logits of the other
    variants with `defer_upsample=True`. `alpha2` and `alpha3` ESP modules
    follow the strided ones at 1/4 and 1/8."""

    ARCH_TYPES = ('espnet', 'espnet-a', 'espnet-b', 'espnet-c')

    def __init__(self, num_class: int = 1, arch_type: str = 'espnet',
                 alpha2: int = 2, alpha3: int = 8,
                 block_channel=(16, 64, 128), act_type: str = 'prelu',
                 device=None):
        super().__init__()
        if arch_type not in self.ARCH_TYPES:
            raise ValueError(f'Unsupport architecture type: {arch_type}.')
        a, d = act_type, device
        self.use_skip = arch_type in ('espnet', 'espnet-b', 'espnet-c')
        self.reinforce = arch_type in ('espnet', 'espnet-c')
        self.use_decoder = arch_type == 'espnet'
        bc = list(block_channel)
        if arch_type == 'espnet-a':
            bc[2] = bc[1]
        self.alpha2, self.alpha3 = alpha2, alpha3
        self.ConvBNAct_0 = ConvBNAct(3, bc[0], 3, 2, act_type=a, device=d)
        c = bc[0] + 3 * self.reinforce
        l1 = c
        self.ESPModule_0 = ESPModule(c, bc[1], stride=2, act_type=a,
                                     device=d)
        for i in range(1, alpha2 + 1):
            setattr(self, f'ESPModule_{i}', ESPModule(bc[1], bc[1],
                                                      act_type=a, device=d))
        c = bc[1] * (1 + self.use_skip) + 3 * self.reinforce
        l2 = c
        n = alpha2 + 1
        setattr(self, f'ESPModule_{n}', ESPModule(c, 128, stride=2,
                                                  act_type=a, device=d))
        for i in range(n + 1, n + alpha3 + 1):
            setattr(self, f'ESPModule_{i}', ESPModule(128, 128, act_type=a,
                                                      device=d))
        c = 128 * (1 + self.use_skip)
        if self.use_decoder:
            self.ConvBNAct_1 = ConvBNAct(c, num_class, 1, act_type=a,
                                         device=d)
            self.Decoder_0 = Decoder(num_class, l1, l2, a, device=d)
        else:
            self.Conv_0 = Conv(c, num_class, 1, device=d)

    def _stage(self, x, first: int, n: int):
        """The strided module `first`, its `n` followers, and the strided
        module's output concatenated where the variant skips."""
        x = skip = getattr(self, f'ESPModule_{first}')(x)
        for i in range(first + 1, first + n + 1):
            x = getattr(self, f'ESPModule_{i}')(x)
        return torch.cat([x, skip], dim=1) if self.use_skip else x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x_input = x.permute(0, 3, 1, 2)   # NHWC -> channels_last NCHW
        x = x_l1 = self.ConvBNAct_0(x)
        if self.reinforce:
            half = resize_bilinear_nchw(x_input, x.shape[2:4],
                                        align_corners=False)
            x = x_l1 = torch.cat([x, half], dim=1)
        x = self._stage(x, 0, self.alpha2)
        if self.reinforce:
            quarter = resize_bilinear_nchw(x_input, x.shape[2:4],
                                           align_corners=False)
            x = torch.cat([x, quarter], dim=1)
        x_l2 = x
        x = self._stage(x, self.alpha2 + 1, self.alpha3)
        if self.use_decoder:
            x = self.Decoder_0(self.ConvBNAct_1(x), x_l1, x_l2)
            return x.permute(0, 2, 3, 1)
        x = self.Conv_0(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
