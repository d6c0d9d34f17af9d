"""FarSee-Net (arXiv:2003.03913), the port of rtseg_tpu/models/farseenet.py.

A ResNet frontend and the FASPP backend: parallel 1x1 and dilated
depth-wise branches over the 1/32 features, a 2x pixel shuffle to 1/16,
fusion with the 1/16 features through a second set of branches, and a 4x
pixel shuffle of the class maps to 1/4; then the final align-corners
upsample. Output stride 1/4.

FASPP creates its submodules inline, so Flax names them by class and order
of creation; `_Scope` hands out the same names in the same order.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct, DWConvBNAct
from ..ops.resize import final_upsample, pixel_shuffle_nchw
from .backbone import ResNet
from .ddrnet import _Scope


class FASPP(nn.Module):
    def __init__(self, high_channels: int, low_channels: int, num_class: int,
                 act_type: str = 'relu', dilations: tuple = (6, 12, 18),
                 hid_channels: int = 256, device=None):
        super().__init__()
        hid, a, d = hid_channels, act_type, device
        scope = _Scope(self)

        def cba(c_in, c_out, k=1):
            return scope.add(ConvBNAct(c_in, c_out, k, act_type=a, device=d))

        def branches(c_in, c_out, dils):
            out = [(cba(c_in, c_out), None)]
            for dt in dils:
                out.append((cba(c_in, c_out), scope.add(DWConvBNAct(
                    c_out, c_out, 3, dilation=dt, act_type=a, device=d))))
            return out

        # high-level branches, then the sub-pixel upsample to 1/16
        self.high = branches(high_channels, hid, dilations)
        self.high_fuse = scope.add(Conv(hid * len(self.high), hid * 2 * 4, 1,
                                        device=d))
        # low-level fusion, then the class maps' sub-pixel upsample to 1/4
        self.low = cba(low_channels, 48)
        self.mid = branches(hid * 2 + 48, hid // 2, dilations[:-1])
        self.tail = [cba(hid // 2 * len(self.mid), hid * 2),
                     cba(hid * 2, hid * 2, 3),
                     scope.add(Conv(hid * 2, num_class * 16, 1, device=d))]

    def _branches(self, x, branches):
        m = self.get_submodule
        feats = []
        for conv, dw in branches:
            y = m(conv)(x)
            feats.append(m(dw)(y) if dw else y)
        return torch.cat(feats, dim=1)

    def forward(self, x_high, x_low):
        m = self.get_submodule
        x = m(self.high_fuse)(self._branches(x_high, self.high))
        x = pixel_shuffle_nchw(x, 2)
        x = torch.cat([x, m(self.low)(x_low)], dim=1)
        x = self._branches(x, self.mid)
        for name in self.tail:
            x = m(name)(x)
        return pixel_shuffle_nchw(x, 4)


class FarSeeNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/4-resolution logits with `defer_upsample=True`."""

    def __init__(self, num_class: int = 1, backbone_type: str = 'resnet18',
                 act_type: str = 'relu', device=None):
        super().__init__()
        if 'resnet' not in backbone_type:
            raise NotImplementedError()
        self.frontend = ResNet(backbone_type, device=device)
        _, _, c3, c4 = self.frontend.channels
        self.FASPP_0 = FASPP(c4, c3, num_class, act_type, device=device)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        _, _, x_low, x_high = self.frontend(x)
        x = self.FASPP_0(x_high, x_low)
        return final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
