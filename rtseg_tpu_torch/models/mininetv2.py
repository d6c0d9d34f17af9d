"""MiniNetv2 (IEEE 9023474), the port of rtseg_tpu/models/mininetv2.py.

Two ENet initial-block paths from the image: a reference path to 1/4, and
the main path to 1/4 (ten multi-dilation depth-wise separable convs) and
1/8 (one for each of `feat_dt`'s dilations); a transposed conv back to
1/4, the reference path added, four more separable convs, and a
DeConvBNAct to the classes that leaves the logits at 1/2, then the final
align-corners upsample (deferred for the fused head, K1, at output stride
2). Submodules carry the Flax scope names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..nn import DeConvBNAct, DWConvBNAct, PWConvBNAct
from ..ops.resize import final_upsample
from .ddrnet import _Scope
from .enet import InitialBlock


class MultiDilationDSConv(nn.Module):
    """A depth-wise ConvBNAct, plus a dilated one beside it where the
    dilation is above 1, summed, then a point-wise ConvBNAct (with bias).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, a, d = in_channels, act_type, device
        self.DWConvBNAct_0 = DWConvBNAct(c, c, kernel_size, stride, 1, a,
                                         device=d)
        self.dilated = dilation > 1
        if self.dilated:
            self.DWConvBNAct_1 = DWConvBNAct(c, c, kernel_size, stride,
                                             dilation, a, device=d)
        self.PWConvBNAct_0 = PWConvBNAct(c, out_channels, a, device=d)

    def forward(self, x):
        y = self.DWConvBNAct_0(x)
        if self.dilated:
            y = y + self.DWConvBNAct_1(x)
        return self.PWConvBNAct_0(y)


class MiniNetv2(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/2-resolution logits with `defer_upsample=True`.
    """

    def __init__(self, num_class: int = 1,
                 feat_dt: Sequence[int] = (1, 2, 1, 4, 1, 8, 1, 16, 1, 1, 1,
                                           2, 1, 4, 1, 8),
                 act_type: str = 'relu', device=None):
        super().__init__()
        a, d = act_type, device
        # reference path: InitialBlock_0, _1; main path: _2, _3, then _4
        for i, (cin, cout) in enumerate(((3, 16), (16, 64), (3, 16),
                                         (16, 64), (64, 128))):
            setattr(self, f'InitialBlock_{i}',
                    InitialBlock(cin, cout, a, device=d))
        self.DeConvBNAct_0 = DeConvBNAct(128, 64, act_type=a, device=d)
        self.DeConvBNAct_1 = DeConvBNAct(64, num_class, act_type=a, device=d)
        scope = _Scope(self)
        convs = [(64, 64, 1)] * 10 + [(128, 128, r) for r in feat_dt] + \
            [(64, 64, 1)] * 4
        self.convs = [scope.add(MultiDilationDSConv(cin, cout, dilation=r,
                                                    act_type=a, device=d))
                      for cin, cout, r in convs]

    def _convs(self, x, first: int, last: int):
        for name in self.convs[first:last]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_ref = self.InitialBlock_1(self.InitialBlock_0(x))
        y = self._convs(self.InitialBlock_3(self.InitialBlock_2(x)), 0, 10)
        n = len(self.convs) - 4
        y = self._convs(self.InitialBlock_4(y), 10, n)
        y = self._convs(self.DeConvBNAct_0(y) + x_ref, n, n + 4)
        y = self.DeConvBNAct_1(y)
        return final_upsample(y, size, defer=defer_upsample).permute(0, 2, 3, 1)
