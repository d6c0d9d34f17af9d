"""ResNet-18/34/50/101/152 and MobileNetV2 backbones, the port of
rtseg_tpu/models/backbone.py. Each returns its four stage features at 1/4,
1/8, 1/16 and 1/32 (NCHW).

Submodules carry the Flax scope names of the JAX backbones (`conv1`,
`bn1`, `layer{i}_{j}`, `downsample_conv`, `block{idx}`, `expand_bn`, ...),
so utils/convert.py maps the weights path by path. The JAX blocks decide
at trace time, from the input's channel count, whether they need a
downsample branch (or a residual); these decide it at construction from
the known input channels, which gives the same modules.

Weights are random from a seed; loading torchvision's ImageNet weights
(the JAX package's utils/torch_import.py) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..nn import BatchNorm, Conv
from ..ops.pool import max_pool_nchw

RESNET_LAYERS = {
    'resnet18': ('basic', (2, 2, 2, 2)),
    'resnet34': ('basic', (3, 4, 6, 3)),
    'resnet50': ('bottleneck', (3, 4, 6, 3)),
    'resnet101': ('bottleneck', (3, 4, 23, 3)),
    'resnet152': ('bottleneck', (3, 8, 36, 3)),
}


def _relu6(x):
    return torch.clamp(x, 0, 6)


class BasicBlock(nn.Module):
    """Two 3x3 convs and a residual. `dilation2` is conv2's dilation (None:
    conv1's); ICNet's surgical dilation sets it to 1."""
    expansion = 1

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dilation: int = 1, dilation2: Optional[int] = None,
                 device=None):
        super().__init__()
        d2 = dilation if dilation2 is None else dilation2
        self.conv1 = Conv(in_channels, channels, 3, stride, dilation,
                          device=device)
        self.bn1 = BatchNorm(channels, device)
        self.conv2 = Conv(channels, channels, 3, 1, d2, device=device)
        self.bn2 = BatchNorm(channels, device)
        self.down = stride != 1 or in_channels != channels
        if self.down:
            self.downsample_conv = Conv(in_channels, channels, 1, stride,
                                        device=device)
            self.downsample_bn = BatchNorm(channels, device)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.downsample_bn(self.downsample_conv(x)) \
            if self.down else x
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 to `channels`, 3x3 (strided, dilated), 1x1 to 4 x `channels`,
    and a residual."""
    expansion = 4

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dilation: int = 1, device=None):
        super().__init__()
        out_c = channels * 4
        self.conv1 = Conv(in_channels, channels, 1, device=device)
        self.bn1 = BatchNorm(channels, device)
        self.conv2 = Conv(channels, channels, 3, stride, dilation,
                          device=device)
        self.bn2 = BatchNorm(channels, device)
        self.conv3 = Conv(channels, out_c, 1, device=device)
        self.bn3 = BatchNorm(out_c, device)
        self.down = stride != 1 or in_channels != out_c
        if self.down:
            self.downsample_conv = Conv(in_channels, out_c, 1, stride,
                                        device=device)
            self.downsample_bn = BatchNorm(out_c, device)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) \
            if self.down else x
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """torchvision-layout ResNet: a 7x7 stride-2 stem, a 3x3 stride-2 max
    pool and four stages of 64, 128, 256 and 512 (x4 for Bottleneck)
    channels. A stage whose `dilations` entry is above 1 keeps stride 1,
    and only its first block's first 3x3 carries the dilation (ICNet's
    surgical rewrite of torchvision's stride-2 convs)."""

    def __init__(self, resnet_type: str = 'resnet18',
                 dilations: Sequence[int] = (1, 1, 1, 1), device=None):
        super().__init__()
        if resnet_type not in RESNET_LAYERS:
            raise ValueError(f'Unsupported ResNet type: {resnet_type}.')
        kind, layers = RESNET_LAYERS[resnet_type]
        block = BasicBlock if kind == 'basic' else Bottleneck
        self.conv1 = Conv(3, 64, 7, 2, padding=3, device=device)
        self.bn1 = BatchNorm(64, device)
        self.stages = []
        in_c = 64
        for i, (n, c) in enumerate(zip(layers, (64, 128, 256, 512))):
            dil = dilations[i]
            stride = 1 if (i == 0 or dil > 1) else 2
            names = []
            for j in range(n):
                kw = {'dilation2': 1} if (kind == 'basic' and dil > 1) else {}
                name = f'layer{i + 1}_{j}'
                self.add_module(name, block(
                    in_c, c, stride if j == 0 else 1, dil if j == 0 else 1,
                    device=device, **kw))
                in_c = c * block.expansion
                names.append(name)
            self.stages.append(names)
        self.channels = tuple(c * block.expansion for c in (64, 128, 256, 512))

    def forward(self, x, stages: int = 4):
        """The features of the first `stages` stages (all four unless a
        caller needs fewer)."""
        x = torch.relu(self.bn1(self.conv1(x)))
        x = max_pool_nchw(x, 3, 2, 1)
        feats = []
        for names in self.stages[:stages]:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


class MBInvertedResidual(nn.Module):
    """torchvision's MobileNetV2 inverted residual (ReLU6): an expanding
    1x1 (unless the ratio is 1), a depth-wise 3x3 (strided, dilated), a
    projecting 1x1, and a residual where the shape allows it."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 expand_ratio: int, dilation: int = 1, device=None):
        super().__init__()
        hid = int(round(in_channels * expand_ratio))
        self.use_res = stride == 1 and in_channels == out_channels
        self.expand_ratio = expand_ratio
        if expand_ratio != 1:
            self.expand = Conv(in_channels, hid, 1, device=device)
            self.expand_bn = BatchNorm(hid, device)
        self.dw = Conv(hid, hid, 3, stride, dilation, groups=hid,
                       device=device)
        self.dw_bn = BatchNorm(hid, device)
        self.project = Conv(hid, out_channels, 1, device=device)
        self.project_bn = BatchNorm(out_channels, device)

    def forward(self, x):
        y = x
        if self.expand_ratio != 1:
            y = _relu6(self.expand_bn(self.expand(y)))
        y = _relu6(self.dw_bn(self.dw(y)))
        y = self.project_bn(self.project(y))
        return x + y if self.use_res else y


# torchvision mobilenet_v2 inverted-residual schedule: (t, c, n, s)
_MBV2_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class Mobilenetv2(nn.Module):
    """MobileNetV2 features split after blocks 3, 6 and 13 and at the end:
    1/4 (24 channels), 1/8 (32), 1/16 (96), 1/32 (320)."""

    SPLITS = (3, 6, 13)
    channels = (24, 32, 96, 320)

    def __init__(self, device=None):
        super().__init__()
        self.stem = Conv(3, 32, 3, 2, device=device)
        self.stem_bn = BatchNorm(32, device)
        idx, in_c = 0, 32
        for t, c, n, s in _MBV2_SETTING:
            for j in range(n):
                idx += 1
                setattr(self, f'block{idx}', MBInvertedResidual(
                    in_c, c, s if j == 0 else 1, t, device=device))
                in_c = c
        self.n_blocks = idx

    def forward(self, x):
        x = _relu6(self.stem_bn(self.stem(x)))
        feats = []
        for idx in range(1, self.n_blocks + 1):
            x = getattr(self, f'block{idx}')(x)
            if idx in self.SPLITS:
                feats.append(x)
        feats.append(x)
        return tuple(feats)


def build_backbone(backbone_type: str, device=None) -> nn.Module:
    """ResNet of `backbone_type`, or MobileNetV2 for 'mobilenet_v2'."""
    if 'resnet' in backbone_type:
        return ResNet(backbone_type, device=device)
    if backbone_type == 'mobilenet_v2':
        return Mobilenetv2(device=device)
    raise NotImplementedError(f'Unsupported backbone: {backbone_type}')
