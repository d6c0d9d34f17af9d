"""ICNet (arXiv:1704.08545), the port of rtseg_tpu/models/icnet.py.

A three-resolution cascade (1, 1/2, 1/4 of the input) sharing one dilated
ResNet (dilations 1, 1, 2, 4: layer3 and layer4 keep stride 1), the
pyramid pooling module on the lowest branch, two cascade feature fusion
units with their aux classifiers, SegHead at 1/4 and the final
align-corners upsample. Output stride 1/4.

The backbone is one module called twice, first on the 1/4 input and then
on the 1/2 input, as the JAX model calls it. In training both calls run
all four stages although the second uses only layer2's features: each
call moves every BatchNorm's running statistics, and the second call's
updates of layer3 and layer4 are part of the state the JAX step returns.
Out of training those two stages change nothing, so the second call stops
after layer2, as XLA drops them from the jitted JAX eval step.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, ConvBNAct, PyramidPoolingModule, SegHead
from ..ops.resize import final_upsample, resize_bilinear_nchw
from .backbone import ResNet


def _up2(x):
    return resize_bilinear_nchw(x, (x.shape[2] * 2, x.shape[3] * 2),
                                align_corners=True)


class CascadeFeatureFusionUnit(nn.Module):
    """x1 upsampled 2x through a dilated 3x3 ConvBN, plus x2 through a 1x1
    ConvBN, activated; with `use_aux` also a SegHead's logits on the
    upsampled x1 (`classifier`)."""

    def __init__(self, in_channels1: int, in_channels2: int,
                 out_channels: int, num_class: int, act_type: str = 'relu',
                 use_aux: bool = True, device=None):
        super().__init__()
        self.use_aux = use_aux
        if use_aux:
            self.classifier = SegHead(in_channels1, num_class, act_type,
                                      device=device)
        self.ConvBNAct_0 = ConvBNAct(in_channels1, out_channels, 3, 1, 2,
                                     act_type='none', device=device)
        self.ConvBNAct_1 = ConvBNAct(in_channels2, out_channels, 1,
                                     act_type='none', device=device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, x1, x2, aux: bool = False):
        x1 = _up2(x1)
        x_aux = self.classifier(x1) if aux else None
        x = self.Activation_0(self.ConvBNAct_0(x1) + self.ConvBNAct_1(x2))
        return x, x_aux


class HighResolutionBranch(nn.Module):
    """Three 3x3 stride-2 ConvBNActs to 1/8."""

    def __init__(self, out_channels: int = 128, hid_channels: int = 32,
                 act_type: str = 'relu', device=None):
        super().__init__()
        h, a, d = hid_channels, act_type, device
        self.ConvBNAct_0 = ConvBNAct(3, h, 3, 2, act_type=a, device=d)
        self.ConvBNAct_1 = ConvBNAct(h, h * 2, 3, 2, act_type=a, device=d)
        self.ConvBNAct_2 = ConvBNAct(h * 2, out_channels, 3, 2, act_type=a,
                                     device=d)

    def forward(self, x):
        return self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))


class ICNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/4-resolution logits with `defer_upsample=True`.
    In training with `use_aux` it returns (logits, (aux2, aux3)), the aux
    logits NHWC at 1/16 and 1/8."""

    def __init__(self, num_class: int = 1, backbone_type: str = 'resnet18',
                 act_type: str = 'relu', use_aux: bool = True, device=None):
        super().__init__()
        if 'resnet' not in backbone_type:
            raise NotImplementedError()
        a, d = act_type, device
        self.use_aux = use_aux
        self.backbone = ResNet(backbone_type, dilations=(1, 1, 2, 4),
                               device=d)
        _, c2, _, c4 = self.backbone.channels
        self.bottom_branch = HighResolutionBranch(128, act_type=a, device=d)
        self.ppm = PyramidPoolingModule(c4, 256, act_type=a, device=d)
        self.cff42 = CascadeFeatureFusionUnit(256, c2, 128, num_class, a,
                                              use_aux, device=d)
        self.cff21 = CascadeFeatureFusionUnit(128, 128, 128, num_class, a,
                                              use_aux, device=d)
        self.seg_head = SegHead(128, num_class, a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_d2 = resize_bilinear_nchw(x, (size[0] // 2, size[1] // 2),
                                    align_corners=True)
        x_d4 = resize_bilinear_nchw(x, (size[0] // 4, size[1] // 4),
                                    align_corners=True)
        # lowest resolution: the whole dilated backbone and the PPM
        x_d4 = self.ppm(self.backbone(x_d4)[3])
        # medium resolution: layer2 of the same backbone (every stage runs
        # in training, for the running statistics)
        f2 = self.backbone(x_d2, 4 if self.training else 2)[1]
        xh = self.bottom_branch(x)
        aux_on = self.training and self.use_aux
        x_d2, aux2 = self.cff42(x_d4, f2, aux_on)
        xh, aux3 = self.cff21(x_d2, xh, aux_on)
        xh = self.seg_head(_up2(xh))
        xh = final_upsample(xh, size, defer=defer_upsample).permute(0, 2, 3, 1)
        if aux_on:
            return xh, (aux2.permute(0, 2, 3, 1), aux3.permute(0, 2, 3, 1))
        return xh
