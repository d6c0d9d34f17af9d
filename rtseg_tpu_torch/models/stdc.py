"""STDC (arXiv:2104.13188), the port of rtseg_tpu/models/stdc.py.

An STDC1 or STDC2 encoder (modules that concatenate shrinking conv blocks)
to 1/32, the BiSeNetv1 attention refinement and feature fusion decoder to
1/8, SegHead and the final align-corners upsample. Optionally three aux
heads (1/8, 1/16, 1/32) or a detail head at 1/8, never both. Submodules
carry the Flax scope names of the JAX model.

The detail head's ground truth is the model's own 1x1 `detail_conv` over
the Laplacian pyramid of the masks (`detail_targets`, called by the train
step on detached weights). The forward never calls `detail_conv`, so it
gets no gradient; the train step still hands it to SGD with a zero
gradient, so that weight decay moves it as optax does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, SegHead
from ..ops.pool import avg_pool_nchw, global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .bisenetv1 import AttentionRefinementModule, FeatureFusionModule

REPEAT_TIMES_HUB = {'stdc1': (1, 1, 1), 'stdc2': (3, 4, 2)}


class STDCModule(nn.Module):
    """Concat of a 1x1 half, a 3x3 quarter (strided) and two 3x3 eighths."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 device=None):
        super().__init__()
        c = out_channels
        if c % 8 != 0:
            raise ValueError('Output channel should be evenly divided by 8.')
        if stride not in (1, 2):
            raise ValueError(f'Unsupported stride: {stride}')
        self.stride = stride
        self.ConvBNAct_0 = ConvBNAct(in_channels, c // 2, 1, device=device)
        self.ConvBNAct_1 = ConvBNAct(c // 2, c // 4, 3, stride, device=device)
        self.ConvBNAct_2 = ConvBNAct(c // 4, c // 8, 3, device=device)
        self.ConvBNAct_3 = ConvBNAct(c // 8, c // 8, 3, device=device)

    def forward(self, x):
        x1 = self.ConvBNAct_0(x)
        x2 = self.ConvBNAct_1(x1)
        if self.stride == 2:
            x1 = avg_pool_nchw(x1, 3, 2, 1)
        x3 = self.ConvBNAct_2(x2)
        x4 = self.ConvBNAct_3(x3)
        return torch.cat([x1, x2, x3, x4], dim=1)


class Stage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 repeat_times: int, device=None):
        super().__init__()
        self.n = repeat_times + 1
        self.STDCModule_0 = STDCModule(in_channels, out_channels, 2,
                                       device=device)
        for i in range(1, self.n):
            setattr(self, f'STDCModule_{i}',
                    STDCModule(out_channels, out_channels, 1, device=device))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'STDCModule_{i}')(x)
        return x


class STDC(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`.
    In training it also returns the detail logits [B, H/8, W/8, 1] with
    `use_detail_head`, or the three aux logits with `use_aux`."""

    def __init__(self, num_class: int = 1, encoder_type: str = 'stdc1',
                 use_detail_head: bool = False, use_aux: bool = False,
                 act_type: str = 'relu', hires_remat: bool = False,
                 device=None):
        super().__init__()
        if encoder_type not in REPEAT_TIMES_HUB:
            raise ValueError('Unsupported encoder type.')
        if use_detail_head and use_aux:
            raise ValueError(
                'Currently only support either aux-head or detail head.')
        if hires_remat:
            raise NotImplementedError(
                'STDC in the PyTorch port does not implement the TPU lever '
                'hires_remat (see ROADMAP.md); unset it')
        rep = REPEAT_TIMES_HUB[encoder_type]
        a, d = act_type, device
        self.use_detail_head, self.use_aux = use_detail_head, use_aux
        self.stage1 = ConvBNAct(3, 32, 3, 2, device=d)
        self.stage2 = ConvBNAct(32, 64, 3, 2, device=d)
        self.stage3 = Stage(64, 256, rep[0], device=d)
        self.stage4 = Stage(256, 512, rep[1], device=d)
        self.stage5 = Stage(512, 1024, rep[2], device=d)
        if use_aux:
            self.aux_head3 = SegHead(256, num_class, a, device=d)
            self.aux_head4 = SegHead(512, num_class, a, device=d)
            self.aux_head5 = SegHead(1024, num_class, a, device=d)
        self.arm4 = AttentionRefinementModule(512, device=d)
        self.arm5 = AttentionRefinementModule(1024, device=d)
        self.conv4 = Conv(512, 256, 1, device=d)
        self.conv5 = Conv(1024, 256, 1, device=d)
        self.ffm = FeatureFusionModule(256 + 256, 128, a, device=d)
        self.seg_head = SegHead(128, num_class, a, device=d)
        if use_detail_head:
            self.detail_head = SegHead(256, 1, a, device=d)
            self.detail_conv = Conv(3, 1, 1, device=d)

    def detail_targets(self, pyramid: torch.Tensor) -> torch.Tensor:
        """The 1x1 `detail_conv` over the NHWC Laplacian pyramid of the
        masks [B, H, W, 3] -> [B, H, W, 1].

        The train step thresholds these values, so a rounding that moves
        one across the threshold flips a target. The conv is written as
        products summed channel by channel in a fixed order, which rounds
        the same on the CPU and on the card (a convolution algorithm would
        choose its own order)."""
        w = self.detail_conv.conv.weight.to(pyramid.dtype).reshape(-1)
        y = pyramid[..., :1] * w[0]
        for i in range(1, w.shape[0]):
            y = y + pyramid[..., i:i + 1] * w[i]
        return y

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x3 = self.stage3(self.stage2(self.stage1(x)))            # 1/8
        x4 = self.stage4(x3)                                     # 1/16
        x5 = self.stage5(x4)                                     # 1/32
        aux_on = self.training and self.use_aux
        if aux_on:
            aux = (self.aux_head3(x3), self.aux_head4(x4),
                   self.aux_head5(x5))

        x5 = self.conv5(global_avg_pool_nchw(x5) + self.arm5(x5))
        x5 = resize_bilinear_nchw(x5, (x5.shape[2] * 2, x5.shape[3] * 2),
                                  align_corners=True)
        x4 = self.conv4(self.arm4(x4)) + x5
        x4 = resize_bilinear_nchw(x4, (x4.shape[2] * 2, x4.shape[3] * 2),
                                  align_corners=True)
        x = self.seg_head(self.ffm(x4, x3))
        x = final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)

        if self.training and self.use_detail_head:
            return x, self.detail_head(x3).permute(0, 2, 3, 1)
        if aux_on:
            return x, tuple(a.permute(0, 2, 3, 1) for a in aux)
        return x
