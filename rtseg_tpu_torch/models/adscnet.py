"""ADSCNet (s10489-019-01587-1), the port of rtseg_tpu/models/adscnet.py.

Asymmetric depth-wise separable modules (a (3,1) depth-wise ConvBNAct, a
1x1 conv, a (1,3) depth-wise ConvBNAct, a 1x1 conv; added to the input, or
at stride 2 concatenated with its avg_pool(3,2,1)) to 1/8, a dense dilated
concat context block (DDCC: each branch a 1x1 projection of everything
before it, a same-size avg pool of window d and padding d // 2 for d up to
13, counting the padding, and a dilated module), and a decoder of three
transposed convs, the first two followed by modules and added to the
encoder's features; the logits come at full size (the eval step takes the
plain argmax; K1 is never launched). ReLU6 but in the transposed convs.
The pools run through `avg_pool_nchw` (ops/pool.py says why). Submodules
carry the Flax scope names.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, DeConvBNAct, DWConvBNAct
from ..ops.pool import avg_pool_nchw


class ADSCModule(nn.Module):
    def __init__(self, channels: int, stride: int = 1, dilation: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError('Unsupported stride type.')
        c, a, d = channels, act_type, device
        self.stride = stride
        self.DWConvBNAct_0 = DWConvBNAct(c, c, (3, 1), stride, dilation, a,
                                         device=d)
        self.Conv_0 = Conv(c, c, 1, device=d)
        self.DWConvBNAct_1 = DWConvBNAct(c, c, (1, 3), 1, dilation, a,
                                         device=d)
        self.Conv_1 = Conv(c, c, 1, device=d)

    def forward(self, x):
        y = self.Conv_0(self.DWConvBNAct_0(x))
        y = self.Conv_1(self.DWConvBNAct_1(y))
        if self.stride == 1:
            return x + y
        return torch.cat([y, avg_pool_nchw(x, 3, 2, 1)], dim=1)


class DDCC(nn.Module):
    def __init__(self, channels: int, dilations=(3, 5, 9, 13),
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, d = channels, device
        self.dilations = tuple(dilations)
        for i, r in enumerate(self.dilations):
            if i > 0:
                setattr(self, f'proj{i + 1}', Conv(c * (i + 1), c, 1,
                                                   device=d))
            setattr(self, f'ADSCModule_{i}',
                    ADSCModule(c, 1, r, act_type, device=d))
        self.conv_last = Conv(c * (len(self.dilations) + 1), c, 1, device=d)

    def forward(self, x):
        feats = [x]
        for i, r in enumerate(self.dilations):
            y = torch.cat(feats, dim=1)
            if i > 0:
                y = getattr(self, f'proj{i + 1}')(y)
            y = avg_pool_nchw(y, r, 1, r // 2)
            feats.append(getattr(self, f'ADSCModule_{i}')(y))
        return self.conv_last(torch.cat(feats, dim=1))


class ADSCNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C] at full size (also with `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu6',
                 device=None):
        super().__init__()
        a, d = act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, 32, 3, 2, act_type=a, device=d)
        for i, (c, s) in enumerate(((32, 1), (32, 1), (32, 2), (64, 1),
                                    (64, 2))):
            setattr(self, f'ADSCModule_{i}', ADSCModule(c, s, act_type=a,
                                                        device=d))
        self.DDCC_0 = DDCC(128, (3, 5, 9, 13), a, device=d)
        self.DeConvBNAct_0 = DeConvBNAct(128, 64, device=d)
        self.ADSCModule_5 = ADSCModule(64, act_type=a, device=d)
        self.ADSCModule_6 = ADSCModule(64, act_type=a, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(64, 32, device=d)
        self.ADSCModule_7 = ADSCModule(32, act_type=a, device=d)
        self.DeConvBNAct_2 = DeConvBNAct(32, num_class, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x1 = self.ADSCModule_0(self.ConvBNAct_0(x))
        x4 = self.ADSCModule_3(self.ADSCModule_2(self.ADSCModule_1(x1)))
        x = self.DDCC_0(self.ADSCModule_4(x4))
        x = self.ADSCModule_5(self.DeConvBNAct_0(x)) + x4
        x = self.DeConvBNAct_1(self.ADSCModule_6(x)) + x1
        x = self.DeConvBNAct_2(self.ADSCModule_7(x))
        return x.permute(0, 2, 3, 1)
