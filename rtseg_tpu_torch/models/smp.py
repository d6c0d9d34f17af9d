"""The generic encoder-decoder hub, the port of rtseg_tpu/models/smp.py
(the reference's segmentation_models_pytorch bridge): nine decoders (Unet,
Unet++, LinkNet, FPN, PSPNet, DeepLabV3, DeepLabV3+, MAnet, PAN) on
ResNet-18/34/50/101/152, MobileNetV2 and MixTransformer (MiT-b0..b5)
encoders. `model='smp'` builds one, and so does the KD teacher.

The quirks the JAX package reproduces are reproduced here:

  * a 3x3 segmentation head for unet, unetpp, manet, pan and pspnet, 1x1
    for the others, then the align-corners bilinear upsample to the input
    size (deferred to the fused head in eval, as every port model's);
  * FPN's GroupNorm(32) blocks, computed as Flax computes GroupNorm;
  * PSPNet reads the stride-8 feature. In training the deeper stages still
    run, because their BatchNorm statistics move in the JAX step (and SGD
    decays their weights); out of training the encoder stops after
    layer2, where the jitted JAX eval step drops them;
  * the PSP pool-size-1 branch is a bare biased conv (no BatchNorm), and
    the branches are concatenated before the input;
  * separable ASPP convs in DeepLabV3+ (one BatchNorm after the
    pointwise), plain ones in DeepLabV3; ASPP ends in Dropout(0.5);
  * LinkNet's k4/s2/p1 transposed convs and 32-channel prefinal block;
  * MAnet's PAB: softmax over the flattened hw x hw map, and torch's
    reshape of the (n, hw, c) result straight to (n, c, h, w). The
    attention input is flattened in NHWC order, as the JAX package
    flattens it, so that reshape is already the port's NCHW;
  * PAN's max-pool ladder (three VALID 2x2 pools of the deepest map: at
    output stride 16 the input side must be at least 128, at 32 at least
    256) and align-corners upsampling;
  * smp's uniform dilation: every block of a dilated stage gets stride 1
    and the stage's dilation, its first block and both 3x3s of a
    BasicBlock included (ICNet's ResNet in models/backbone.py dilates only
    the first 3x3 of a stage).

Submodules carry the Flax scope names (`encoder`, `UnetDecoder_0`,
`x_1_2`, `seg_head`, ...), so utils/convert.py maps the weights path by
path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn import (BatchNorm, Conv, ConvBNAct, DeConvBNAct, Dropout,
                  Dropout2d, GroupNorm)
from ..ops.pool import (adaptive_avg_pool_nchw, global_avg_pool_nchw,
                        max_pool_nchw)
from ..ops.resize import (final_upsample, resize_bilinear_nchw,
                          resize_nearest_nchw)
from .backbone import (_MBV2_SETTING, RESNET_LAYERS, BasicBlock, Bottleneck,
                       MBInvertedResidual)
from .mit import MixTransformer

SMP_DECODERS = ('deeplabv3', 'deeplabv3p', 'fpn', 'linknet', 'manet', 'pan',
                'pspnet', 'unet', 'unetpp')

# decoders whose smp SegmentationHead uses a 3x3 conv; the rest use 1x1
HEAD_K3_DECODERS = ('unet', 'unetpp', 'manet', 'pan', 'pspnet')

# encoder name -> channels at strides (2, 4, 8, 16, 32); MixTransformer has
# no stride-2 level (channel 0: the level is None)
ENCODER_CHANNELS = {
    'resnet18': (64, 64, 128, 256, 512),
    'resnet34': (64, 64, 128, 256, 512),
    'resnet50': (64, 256, 512, 1024, 2048),
    'resnet101': (64, 256, 512, 1024, 2048),
    'resnet152': (64, 256, 512, 1024, 2048),
    'mobilenet_v2': (16, 24, 32, 96, 1280),
    'mit_b0': (0, 32, 64, 160, 256),
    'mit_b1': (0, 64, 128, 320, 512),
    'mit_b2': (0, 64, 128, 320, 512),
    'mit_b3': (0, 64, 128, 320, 512),
    'mit_b4': (0, 64, 128, 320, 512),
    'mit_b5': (0, 64, 128, 320, 512),
}

# decoders that need an encoder level or a dilated mode a MixTransformer
# cannot give
MIT_UNSUPPORTED_DECODERS = ('deeplabv3', 'deeplabv3p', 'linknet', 'unetpp')

Feats = Tuple[Optional[torch.Tensor], ...]


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of NCHW `x`."""
    return resize_nearest_nchw(x, (x.shape[2] * 2, x.shape[3] * 2))


def _relu6(x):
    return torch.clamp(x, 0, 6)


def _mbv2_level(idx: int) -> int:
    """MobileNetV2 block index -> the encoder level of its dilation: blocks
    2-3 at stride 4, 4-6 at 8, 7-13 at 16, 14-17 at 32."""
    return 0 if idx <= 3 else 1 if idx <= 6 else 2 if idx <= 13 else 3


class Encoder(nn.Module):
    """Features at strides (2, 4, 8, 16, 32), NCHW; `dilations` relaxes the
    deepest stages to output stride 16 or 8 with smp's uniform scheme."""

    def __init__(self, encoder_name: str = 'resnet18',
                 dilations: Sequence[int] = (1, 1, 1, 1), device=None):
        super().__init__()
        name, dilations = encoder_name, tuple(dilations)
        self.kind = 'mit' if name.startswith('mit_') else name
        if name.startswith('mit_'):
            if dilations != (1, 1, 1, 1):
                raise ValueError(
                    f'Encoder `{name}` does not support dilated mode.')
            self.mit = MixTransformer(name, device=device)
        elif name == 'mobilenet_v2':
            self.stem = Conv(3, 32, 3, 2, device=device)
            self.stem_bn = BatchNorm(32, device)
            idx, in_c = 0, 32
            for t, c, n, s in _MBV2_SETTING:
                for j in range(n):
                    idx += 1
                    dil = dilations[_mbv2_level(idx)] if idx > 1 else 1
                    stride = 1 if dil > 1 else (s if j == 0 else 1)
                    setattr(self, f'block{idx}', MBInvertedResidual(
                        in_c, c, stride, t, dil, device=device))
                    in_c = c
            self.n_blocks = idx
            self.head = Conv(in_c, 1280, 1, device=device)
            self.head_bn = BatchNorm(1280, device)
        elif name in RESNET_LAYERS:
            kind, layers = RESNET_LAYERS[name]
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
                    self.add_module(f'layer{i + 1}_{j}', block(
                        in_c, c, stride if j == 0 else 1, dil,
                        device=device))
                    in_c = c * block.expansion
                    names.append(f'layer{i + 1}_{j}')
                self.stages.append(names)
        else:
            raise ValueError(f'Unsupported encoder: {name}')

    def forward(self, x, levels: int = 5) -> Feats:
        """The features of the first `levels` strides (2, 4, ...); a ResNet
        stops after the last stage asked for."""
        if self.kind == 'mit':
            return (None,) + tuple(self.mit(x))
        if self.kind == 'mobilenet_v2':
            x = _relu6(self.stem_bn(self.stem(x)))
            feats = []
            for idx in range(1, self.n_blocks + 1):
                x = getattr(self, f'block{idx}')(x)
                if idx in (1, 3, 6, 13):
                    feats.append(x)
            feats.append(_relu6(self.head_bn(self.head(x))))
            return tuple(feats)
        x = torch.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = max_pool_nchw(x, 3, 2, 1)
        for names in self.stages[:levels - 1]:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


# --------------------------------------------------------------------- blocks

class Conv2ReLU(nn.Module):
    """smp Conv2dReLU: a bias-free 3x3 conv, BatchNorm and ReLU."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels, 3,
                                     device=device)

    def forward(self, x):
        return self.ConvBNAct_0(x)


class SeparableConvBNReLU(nn.Module):
    """A depth-wise 3x3 then a pointwise 1x1 (both bias-free), one
    BatchNorm after the pointwise, ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 dilation: int = 1, device=None):
        super().__init__()
        self.dw = Conv(in_channels, in_channels, 3, 1, dilation,
                       groups=in_channels, device=device)
        self.pw = Conv(in_channels, out_channels, 1, device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.pw(self.dw(x))))


class UnetBlock(nn.Module):
    """Nearest x2 up, the skip concatenated, two Conv2ReLUs."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, device=None):
        super().__init__()
        self.Conv2ReLU_0 = Conv2ReLU(in_channels + skip_channels,
                                     out_channels, device)
        self.Conv2ReLU_1 = Conv2ReLU(out_channels, out_channels, device)

    def forward(self, x, skip=None):
        x = _up2(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.Conv2ReLU_1(self.Conv2ReLU_0(x))


def atrous_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """`conv` (3x3, stride 1, dilation d, padding d) over NCHW `x` as an
    undilated 3x3 conv over the d x d phases of `x` (space to batch, as
    TensorFlow's atrous_conv2d computes it): the same products and sums,
    the map zero-padded up to a multiple of d. On a channels_last bf16
    map of 128x256 at rates 12 to 36, cuDNN's own choice for the dilated
    conv, a direct kernel, takes 1.8-2.3 s a call on an H100 (41 ms on a
    contiguous map); the phases are small undilated maps of a large batch.
    A channels_last input gives a channels_last output."""
    d = conv.dilation[0]
    n, c, h, w = x.shape
    hq, wq = -(-h // d), -(-w // d)
    xh = F.pad(x.permute(0, 2, 3, 1), (0, 0, 0, wq * d - w, 0, hq * d - h))
    xs = xh.reshape(n, hq, d, wq, d, c).permute(0, 2, 4, 1, 3, 5)
    xs = xs.reshape(n * d * d, hq, wq, c).permute(0, 3, 1, 2)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(xs, conv.weight.to(x.dtype), bias, 1, 1)
    co = y.shape[1]
    y = y.permute(0, 2, 3, 1).reshape(n, d, d, hq, wq, co)
    y = y.permute(0, 3, 1, 4, 2, 5).reshape(n, hq * d, wq * d, co)
    return y[:, :h, :w].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


class AtrousConvBNAct(ConvBNAct):
    """ConvBNAct of a dilated 3x3 conv, the conv computed by
    `atrous_conv`."""

    def forward(self, x):
        y = atrous_conv(x, self.Conv_0.conv)
        return self.Activation_0(self.BatchNorm_0(y))


class ASPP(nn.Module):
    """[1x1, three rate convs, pooled 1x1] -> 1x1 projection -> Dropout(0.5);
    `separable` makes the rate convs depth-wise separable (DeepLabV3+)."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36),
                 separable: bool = False, device=None):
        super().__init__()
        c, d = out_channels, device
        convs = [ConvBNAct(in_channels, c, 1, device=d)]
        self.branches = ['ConvBNAct_0']
        for i, r in enumerate(atrous_rates):
            if separable:
                name = f'SeparableConvBNReLU_{i}'
                setattr(self, name, SeparableConvBNReLU(in_channels, c, r,
                                                        device=d))
            else:
                name = f'ConvBNAct_{len(convs)}'
                convs.append(AtrousConvBNAct(in_channels, c, 3, dilation=r,
                                             device=d))
            self.branches.append(name)
        convs.append(ConvBNAct(in_channels, c, 1, device=d))      # pooled
        convs.append(ConvBNAct(c * (len(atrous_rates) + 2), c, 1, device=d))
        for i, m in enumerate(convs):
            setattr(self, f'ConvBNAct_{i}', m)
        self.pool, self.project = (f'ConvBNAct_{len(convs) - 2}',
                                   f'ConvBNAct_{len(convs) - 1}')
        self.Dropout_0 = Dropout(0.5)

    def forward(self, x):
        feats = [getattr(self, name)(x) for name in self.branches]
        g = getattr(self, self.pool)(global_avg_pool_nchw(x))
        feats.append(resize_bilinear_nchw(g, x.shape[2:4],
                                          align_corners=False))
        x = getattr(self, self.project)(torch.cat(feats, dim=1))
        return self.Dropout_0(x)


class PSPModule(nn.Module):
    """Branches at pool sizes (1, 2, 3, 6): the size-1 branch a bare
    biased conv and ReLU, the others ConvBNAct 1x1; align-corners
    upsampling; branches concatenated before the input; a 1x1 ConvBNAct."""

    def __init__(self, in_channels: int, out_channels: int = 512,
                 pool_sizes: Sequence[int] = (1, 2, 3, 6), device=None):
        super().__init__()
        hid = in_channels // len(pool_sizes)
        self.pool_sizes = tuple(pool_sizes)
        self.branches, k = [], 0
        for ps in self.pool_sizes:
            if ps == 1:
                name = 'Conv_0'
                setattr(self, name, Conv(in_channels, hid, 1, use_bias=True,
                                         device=device))
            else:
                name = f'ConvBNAct_{k}'
                setattr(self, name, ConvBNAct(in_channels, hid, 1,
                                              device=device))
                k += 1
            self.branches.append(name)
        self.fuse = f'ConvBNAct_{k}'
        setattr(self, self.fuse, ConvBNAct(
            in_channels + hid * len(self.pool_sizes), out_channels, 1,
            device=device))

    def forward(self, x):
        size = x.shape[2:4]
        feats = []
        for ps, name in zip(self.pool_sizes, self.branches):
            y = getattr(self, name)(adaptive_avg_pool_nchw(x, ps))
            if ps == 1:
                y = torch.relu(y)
            feats.append(resize_bilinear_nchw(y, size, align_corners=True))
        return getattr(self, self.fuse)(torch.cat(feats + [x], dim=1))


# ------------------------------------------------------------------- decoders

DECODER_CHANNELS = (256, 128, 64, 32, 16)


class UnetDecoder(nn.Module):
    def __init__(self, enc_channels: Sequence[int], device=None):
        super().__init__()
        skips = list(enc_channels[:-1])[::-1] + [0]
        in_c = enc_channels[-1]
        for i, c in enumerate(DECODER_CHANNELS):
            setattr(self, f'UnetBlock_{i}', UnetBlock(in_c, skips[i], c,
                                                      device))
            in_c = c
        self.out_channels = in_c

    def forward(self, feats: Feats):
        skips = list(feats[:-1])[::-1] + [None]
        x = feats[-1]
        for i in range(len(DECODER_CHANNELS)):
            x = getattr(self, f'UnetBlock_{i}')(x, skips[i])
        return x


class UnetPPDecoder(nn.Module):
    """smp's UnetPlusPlus grid of nodes x_{d}_{l} (depth d, dense layer
    l): x_{d}_{l} takes x_{d}_{l-1} as its up-input and the deeper nodes
    of layer l with the encoder skip as its skip; out channels are the
    decoder's on row 0 and the skip's elsewhere."""

    def __init__(self, enc_channels: Sequence[int], device=None):
        super().__init__()
        rev = list(enc_channels)[::-1]
        self.depth = depth = len(rev) - 1
        skip_ch = rev[1:]
        ch = {}

        def block(d, l, in_c, skip_c):
            out_c = DECODER_CHANNELS[l] if d == 0 else skip_ch[l]
            setattr(self, f'x_{d}_{l}', UnetBlock(in_c, skip_c, out_c,
                                                  device))
            ch[(d, l)] = out_c

        for d in range(depth):
            block(d, d, rev[d], rev[d + 1])
        for layer in range(1, depth):
            for d in range(depth - layer):
                dl = d + layer
                skip_c = sum(ch[(i, dl)] for i in range(d + 1, dl + 1)) \
                    + rev[dl + 1]
                block(d, dl, ch[(d, dl - 1)], skip_c)
        setattr(self, f'x_0_{depth}', UnetBlock(ch[(0, depth - 1)], 0,
                                                DECODER_CHANNELS[-1], device))
        self.out_channels = DECODER_CHANNELS[-1]

    def forward(self, feats: Feats):
        rev = list(feats)[::-1]
        depth = self.depth
        dense = {}
        for d in range(depth):
            dense[(d, d)] = getattr(self, f'x_{d}_{d}')(rev[d], rev[d + 1])
        for layer in range(1, depth):
            for d in range(depth - layer):
                dl = d + layer
                cat = [dense[(i, dl)] for i in range(d + 1, dl + 1)]
                skip = torch.cat(cat + [rev[dl + 1]], dim=1)
                dense[(d, dl)] = getattr(self, f'x_{d}_{dl}')(
                    dense[(d, dl - 1)], skip)
        return getattr(self, f'x_0_{depth}')(dense[(0, depth - 1)])


class LinkNetDecoder(nn.Module):
    """smp LinknetDecoder: a block a skip with the skip added, and a
    prefinal block to 32 channels."""

    def __init__(self, enc_channels: Sequence[int],
                 prefinal_channels: int = 32, device=None):
        super().__init__()
        skips = list(enc_channels[:-1])[::-1]
        in_c = enc_channels[-1]
        self.names = []
        for i, s in enumerate(skips):
            self._block(f'dec{i}', in_c, s, device)
            in_c = s
        self._block('dec_last', in_c, prefinal_channels, device)
        self.out_channels = prefinal_channels

    def _block(self, name, in_c, out_c, device):
        """1x1 reduce to in/4 -> ConvTranspose(k4, s2, p1) -> 1x1 expand,
        each with BatchNorm and ReLU."""
        hid = in_c // 4
        setattr(self, f'{name}_c1', ConvBNAct(in_c, hid, 1, device=device))
        setattr(self, f'{name}_up', DeConvBNAct(
            hid, hid, kernel_size=4, output_padding=0, device=device))
        setattr(self, f'{name}_c2', ConvBNAct(hid, out_c, 1, device=device))
        self.names.append(name)

    def _run(self, name, x):
        for part in ('c1', 'up', 'c2'):
            x = getattr(self, f'{name}_{part}')(x)
        return x

    def forward(self, feats: Feats):
        skips = list(feats[:-1])[::-1]
        x = feats[-1]
        for name, s in zip(self.names, skips):
            x = self._run(name, x) + s
        return self._run('dec_last', x)


class Conv3x3GNReLU(nn.Module):
    """A bias-free 3x3 conv, GroupNorm(32) and ReLU, then nearest x2 where
    `upsample`."""

    def __init__(self, in_channels: int, out_channels: int,
                 upsample: bool = False, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels, 3, device=device)
        self.gn = GroupNorm(32, out_channels, device=device)
        self.upsample = upsample

    def forward(self, x):
        x = torch.relu(self.gn(self.Conv_0(x)))
        return _up2(x) if self.upsample else x


class FPNDecoder(nn.Module):
    """Laterals p5..p2 (biased 1x1) with nearest top-down adds, a tower of
    Conv3x3GNReLU a level to 1/4, summed, Dropout2d(0.2)."""

    def __init__(self, enc_channels: Sequence[int],
                 pyramid_channels: int = 256,
                 segmentation_channels: int = 128, device=None):
        super().__init__()
        pc, sc = pyramid_channels, segmentation_channels
        for i, lvl in zip((5, 4, 3, 2), (4, 3, 2, 1)):
            setattr(self, f'p{i}', Conv(enc_channels[lvl], pc, 1,
                                        use_bias=True, device=device))
        self.towers = []
        for i, n_up in enumerate((3, 2, 1, 0)):
            names = [f'seg{i}_0']
            setattr(self, names[0], Conv3x3GNReLU(pc, sc, bool(n_up),
                                                  device))
            for j in range(1, n_up):
                names.append(f'seg{i}_{j}')
                setattr(self, names[-1], Conv3x3GNReLU(sc, sc, True, device))
            self.towers.append(names)
        self.Dropout2d_0 = Dropout2d(0.2)
        self.out_channels = sc

    def forward(self, feats: Feats):
        c2, c3, c4, c5 = feats[1:5]
        p5 = self.p5(c5)
        p4 = self.p4(c4) + resize_nearest_nchw(p5, c4.shape[2:4])
        p3 = self.p3(c3) + resize_nearest_nchw(p4, c3.shape[2:4])
        p2 = self.p2(c2) + resize_nearest_nchw(p3, c2.shape[2:4])
        x = None
        for p, names in zip((p5, p4, p3, p2), self.towers):
            for name in names:
                p = getattr(self, name)(p)
            x = p if x is None else x + p
        return self.Dropout2d_0(x)


class PABlock(nn.Module):
    """MAnet's position attention: 64-channel top and center maps, 3x3
    bottom and out convs (all biased), softmax in float32 over the
    flattened hw x hw map, and torch's reshape of the (n, hw, c) result to
    (n, c, h, w)."""

    def __init__(self, channels: int, pab_channels: int = 64, device=None):
        super().__init__()
        c, p = channels, pab_channels
        self.top = Conv(c, p, 1, use_bias=True, device=device)
        self.center = Conv(c, p, 1, use_bias=True, device=device)
        self.bottom = Conv(c, c, 3, use_bias=True, device=device)
        self.out = Conv(c, c, 3, use_bias=True, device=device)

    def forward(self, x):
        n, c, h, w = x.shape
        hw = h * w

        def flat(y):            # NHWC order, as the JAX package flattens
            return y.permute(0, 2, 3, 1).reshape(n, hw, -1)

        top = self.top(x)               # called in the JAX package's order
        att = torch.bmm(flat(self.center(x)), flat(top).transpose(1, 2))
        att = torch.softmax(att.reshape(n, hw * hw).float(), dim=-1)
        att = att.reshape(n, hw, hw).to(x.dtype)
        out = torch.bmm(att, flat(self.bottom(x)))
        # torch's (n, hw, c).reshape(n, c, h, w), which is NCHW here
        return self.out(x + out.reshape(n, c, h, w))


class MFABlock(nn.Module):
    """MAnet's multi-scale fusion: a 3x3 and a 1x1 conv on the high path,
    nearest x2, SE gates on the high path and on the skip, concatenated,
    two Conv2ReLUs."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, reduction: int = 16, device=None):
        super().__init__()
        d = device
        self.hl_a = Conv2ReLU(in_channels, in_channels, d)
        self.hl_b = ConvBNAct(in_channels, skip_channels, 1, device=d)
        for name in ('se_hl', 'se_ll'):
            hid = max(1, skip_channels // reduction)
            setattr(self, f'{name}_a', Conv(skip_channels, hid, 1,
                                            use_bias=True, device=d))
            setattr(self, f'{name}_b', Conv(hid, skip_channels, 1,
                                            use_bias=True, device=d))
        self.c1 = Conv2ReLU(2 * skip_channels, out_channels, d)
        self.c2 = Conv2ReLU(out_channels, out_channels, d)

    def _se(self, x, name):
        g = torch.relu(getattr(self, f'{name}_a')(global_avg_pool_nchw(x)))
        return torch.sigmoid(getattr(self, f'{name}_b')(g))

    def forward(self, x, skip):
        x = _up2(self.hl_b(self.hl_a(x)))
        x = x * self._se(x, 'se_hl')
        skip = skip * self._se(skip, 'se_ll')
        return self.c2(self.c1(torch.cat([x, skip], dim=1)))


class MAnetDecoder(nn.Module):
    def __init__(self, enc_channels: Sequence[int], device=None):
        super().__init__()
        self.pab = PABlock(enc_channels[-1], device=device)
        skips = list(enc_channels[:-1])[::-1] + [0]
        in_c = enc_channels[-1]
        self.names = []
        for i, c in enumerate(DECODER_CHANNELS):
            if skips[i]:
                name = f'mfab{i}'
                setattr(self, name, MFABlock(in_c, skips[i], c,
                                             device=device))
            else:
                name = f'up{i}'
                setattr(self, name, UnetBlock(in_c, 0, c, device))
            self.names.append(name)
            in_c = c
        self.out_channels = in_c

    def forward(self, feats: Feats):
        x = self.pab(feats[-1])
        skips = list(feats[:-1])[::-1] + [None]
        for name, skip in zip(self.names, skips):
            x = getattr(self, name)(x) if skip is None else \
                getattr(self, name)(x, skip)
        return x


class PANDecoder(nn.Module):
    """Feature pyramid attention on the deepest level and three global
    attention upsample blocks; align-corners bilinear throughout."""

    def __init__(self, enc_channels: Sequence[int],
                 decoder_channels: int = 32, device=None):
        super().__init__()
        dc, d = decoder_channels, device
        c2, c3, c4, c5 = enc_channels[1:5]

        def cba(name, cin, cout, k, act='relu'):
            setattr(self, name, ConvBNAct(cin, cout, k, bias=True,
                                          act_type=act, device=d))

        cba('fpa_glob', c5, dc, 1)
        cba('fpa_mid', c5, dc, 1)
        cba('fpa_down1', c5, 1, 7)
        cba('fpa_down2', 1, 1, 5)
        cba('fpa_down3a', 1, 1, 3)
        cba('fpa_down3b', 1, 1, 3)
        cba('fpa_conv2', 1, 1, 5)
        cba('fpa_conv1', 1, 1, 7)
        for name, c in (('gau3', c4), ('gau2', c3), ('gau1', c2)):
            cba(f'{name}_low', c, dc, 3)
            cba(f'{name}_g', dc, dc, 1, 'sigmoid')
        self.out_channels = dc

    def _fpa(self, x):
        size = x.shape[2:4]
        g = self.fpa_glob(global_avg_pool_nchw(x))
        g = resize_bilinear_nchw(g, size, align_corners=True)
        mid = self.fpa_mid(x)
        x1 = self.fpa_down1(max_pool_nchw(x, 2, 2))
        x2 = self.fpa_down2(max_pool_nchw(x1, 2, 2))
        x3 = self.fpa_down3b(self.fpa_down3a(max_pool_nchw(x2, 2, 2)))
        x3 = resize_bilinear_nchw(x3, x2.shape[2:4], align_corners=True)
        x2 = self.fpa_conv2(x2) + x3
        x2 = resize_bilinear_nchw(x2, x1.shape[2:4], align_corners=True)
        x1 = self.fpa_conv1(x1) + x2
        x1 = resize_bilinear_nchw(x1, size, align_corners=True)
        return mid * x1 + g

    def _gau(self, x_high, x_low, name):
        up = resize_bilinear_nchw(x_high, x_low.shape[2:4],
                                  align_corners=True)
        low = getattr(self, f'{name}_low')(x_low)
        g = getattr(self, f'{name}_g')(global_avg_pool_nchw(x_high))
        return up + low * g

    def forward(self, feats: Feats):
        c2, c3, c4, c5 = feats[1:5]
        x = self._fpa(c5)
        x = self._gau(x, c4, 'gau3')
        x = self._gau(x, c3, 'gau2')
        return self._gau(x, c2, 'gau1')


_DECODERS = {'unet': UnetDecoder, 'unetpp': UnetPPDecoder,
             'linknet': LinkNetDecoder, 'fpn': FPNDecoder,
             'manet': MAnetDecoder, 'pan': PANDecoder}


# --------------------------------------------------------------------- model

class GenericSegModel(nn.Module):
    """Encoder, decoder and segmentation head, then the align-corners
    bilinear upsample to the input size. Takes NHWC images [B, H, W, 3]
    and returns NHWC logits [B, H, W, C], or the decoder's resolution with
    `defer_upsample=True`."""

    def __init__(self, encoder_name: str = 'resnet18',
                 decoder_name: str = 'unet', num_class: int = 1,
                 device=None):
        super().__init__()
        dec, d = decoder_name, device
        self.decoder_name = dec
        mit = encoder_name.startswith('mit_')
        if dec == 'deeplabv3' and not mit:
            enc_dil = (1, 1, 2, 4)        # output stride 8
        elif dec in ('deeplabv3p', 'pan') and not mit:
            enc_dil = (1, 1, 1, 2)        # output stride 16
        else:
            enc_dil = (1, 1, 1, 1)        # MiT cannot dilate: PAN at 32
        self.encoder = Encoder(encoder_name, enc_dil, device=d)
        ch = ENCODER_CHANNELS[encoder_name]
        if dec in _DECODERS:
            name = f'{_DECODERS[dec].__name__}_0'
            setattr(self, name, _DECODERS[dec](ch, device=d))
            self.decoder = name
            out_c = getattr(self, name).out_channels
        elif dec == 'pspnet':
            self.PSPModule_0 = PSPModule(ch[2], 512, device=d)
            self.Dropout2d_0 = Dropout2d(0.2)
            out_c = 512
        elif dec == 'deeplabv3':
            self.ASPP_0 = ASPP(ch[-1], 256, device=d)
            self.ConvBNAct_0 = ConvBNAct(256, 256, 3, device=d)
            out_c = 256
        elif dec == 'deeplabv3p':
            self.ASPP_0 = ASPP(ch[-1], 256, separable=True, device=d)
            self.aspp_post = SeparableConvBNReLU(256, 256, device=d)
            self.block1 = ConvBNAct(ch[1], 48, 1, device=d)
            self.block2 = SeparableConvBNReLU(256 + 48, 256, device=d)
            out_c = 256
        else:
            raise ValueError(f'Unsupported decoder type: {dec}')
        k = 3 if dec in HEAD_K3_DECODERS else 1
        self.seg_head = Conv(out_c, num_class, k, use_bias=True, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        dec = self.decoder_name
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        if dec == 'pspnet':
            # the stride-8 feature; the deeper stages only in training
            feats = self.encoder(x, 5 if self.training else 3)
            y = self.Dropout2d_0(self.PSPModule_0(feats[2]))
        else:
            feats = self.encoder(x)
            if dec == 'deeplabv3':
                y = self.ConvBNAct_0(self.ASPP_0(feats[-1]))
            elif dec == 'deeplabv3p':
                y = self.aspp_post(self.ASPP_0(feats[-1]))
                y = resize_bilinear_nchw(y, feats[1].shape[2:4],
                                         align_corners=True)
                y = torch.cat([y, self.block1(feats[1])], dim=1)
                y = self.block2(y)
            else:
                y = getattr(self, self.decoder)(feats)
        y = self.seg_head(y)
        if tuple(y.shape[2:4]) != tuple(size):
            y = final_upsample(y, size, defer=defer_upsample)
        return y.permute(0, 2, 3, 1)


def build_smp_model(encoder: str, decoder: str, num_class: int,
                    device=None) -> GenericSegModel:
    """The hub's model for (encoder, decoder), with the JAX package's
    refusals and messages."""
    if decoder not in SMP_DECODERS:
        raise ValueError(f'Unsupported decoder type: {decoder}')
    if encoder not in ENCODER_CHANNELS:
        raise ValueError(f'Unsupported encoder type: {encoder}')
    if encoder.startswith('mit_') and decoder in MIT_UNSUPPORTED_DECODERS:
        raise ValueError(
            f'Encoder `{encoder}` is not supported for `{decoder}')
    return GenericSegModel(encoder, decoder, num_class, device=device)


__all__ = ['ENCODER_CHANNELS', 'GenericSegModel', 'HEAD_K3_DECODERS',
           'MIT_UNSUPPORTED_DECODERS', 'SMP_DECODERS', 'build_smp_model']
