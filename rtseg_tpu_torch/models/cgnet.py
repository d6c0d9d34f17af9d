"""CGNet (arXiv:1811.08201), the port of rtseg_tpu/models/cgnet.py.

Three ConvBNActs to 1/2, then context-guided blocks: a 1x1 reduction, a
local depth-wise 3x3 (`loc`) beside a dilated surround one (`sur`),
concatenated, a joint BatchNorm and PReLU, and a global gate of two
Dense layers (`glo1`, `glo2`) and a sigmoid over the block's channel
means, with the input added after the gate where the shapes allow (the
global residual, GRL, the only kind the model builds). The image resized to 1/4 and 1/8 with
align-corners is concatenated after the first block of each stage; a 1x1
conv to the classes at 1/8 and the final align-corners upsample close the
model. Submodules carry the Flax scope names.

Flax's Dense promotes its bf16 input to its float32 parameters, so with
bf16 activations the gate, and with it everything after the first
block's gating product, runs in float32, as here: the Dense layers
compute in float32, the product of a bf16 map with the float32 gate is
float32, and the convs that follow cast their weights to it; the logits
come out float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, BatchNorm, Conv, ConvBNAct, dense
from ..ops.pool import global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw


class InitBlock(nn.Module):
    def __init__(self, out_channels: int = 32, act_type: str = 'prelu',
                 device=None):
        super().__init__()
        c, a, d = out_channels, act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, c, 3, 2, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(c, c, 3, act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(c, c, 3, act_type=a, device=d)

    def forward(self, x):
        x0 = self.ConvBNAct_0(x)
        return self.ConvBNAct_2(self.ConvBNAct_1(x0)), x0


class CGBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, act_type: str = 'prelu', device=None):
        super().__init__()
        c, h, d = out_channels, out_channels // 2, device
        self.use_skip = stride == 1 and in_channels == c
        self.Conv_0 = Conv(in_channels, h, 1, device=d)
        self.loc = Conv(h, h, 3, stride, groups=h, device=d)
        self.sur = Conv(h, h, 3, stride, dilation=dilation, groups=h,
                        device=d)
        self.BatchNorm_0 = BatchNorm(c, d)
        self.Activation_0 = Activation(act_type, d)
        self.glo1 = nn.Linear(c, c // 8, device=d)
        self.glo2 = nn.Linear(c // 8, c, device=d)

    def forward(self, x):
        residual = x
        x = self.Conv_0(x)
        x = torch.cat([self.loc(x), self.sur(x)], dim=1)
        x = self.Activation_0(self.BatchNorm_0(x))
        g = dense(dense(global_avg_pool_nchw(x).flatten(1), self.glo1),
                  self.glo2)
        x = x * torch.sigmoid(g)[:, :, None, None]
        if self.use_skip:
            x = x + residual
        return x


class CGNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`.
    `M` and `N` blocks run at 1/4 and 1/8, the first of each strided."""

    def __init__(self, num_class: int = 1, M: int = 3, N: int = 15,
                 act_type: str = 'prelu', device=None):
        super().__init__()
        a, d = act_type, device
        self.InitBlock_0 = InitBlock(32, a, device=d)
        cin, i = 64, 0
        for c, r, n in ((64, 2, M), (128, 4, N)):
            # a strided block, the image's 3 channels concatenated, n - 1
            # more, and the strided block's output concatenated
            for j in range(n):
                setattr(self, f'CGBlock_{i}', CGBlock(
                    cin, c, 2 if j == 0 else 1, r, act_type=a, device=d))
                cin, i = (c + 3 if j == 0 else c), i + 1
            cin += c
        self.stages = (M, M + N)
        self.Conv_0 = Conv(cin, num_class, 1, device=d)

    def _stage(self, x, first: int, last: int, img):
        """The strided block `first`, the image concatenated to its output,
        the blocks up to `last`, and the strided block's output
        concatenated."""
        x = skip = getattr(self, f'CGBlock_{first}')(x)
        x = torch.cat([x, img], dim=1)           # input injection
        for i in range(first + 1, last):
            x = getattr(self, f'CGBlock_{i}')(x)
        return torch.cat([x, skip], dim=1)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_d4, x_d8 = (resize_bilinear_nchw(x, (size[0] // s, size[1] // s),
                                           align_corners=True)
                      for s in (4, 8))
        x, x1 = self.InitBlock_0(x)
        x = torch.cat([x, x1], dim=1)
        x = self._stage(x, 0, self.stages[0], x_d4)
        x = self._stage(x, self.stages[0], self.stages[1], x_d8)
        x = self.Conv_0(x)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
