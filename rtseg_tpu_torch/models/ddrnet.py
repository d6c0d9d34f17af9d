"""DDRNet (arXiv:2101.06085), the port of rtseg_tpu/models/ddrnet.py.

Dual-resolution stages with bilateral fusion: a low-resolution branch down
to 1/64 with the DAPPM pyramid (strided average pools, cascaded 3x3 convs
and a global branch) and a high-resolution branch that stays at 1/8,
SegHead at 1/8 and the final align-corners upsample. With `use_aux` the
training forward also returns an aux head's logits on the high branch after
stage 4 (1/8). Arch hub: DDRNet-23-slim, DDRNet-23, DDRNet-39.

The JAX model creates most of its submodules inline, so Flax names them by
class and order of creation on the DDRNet scope (`ConvBNAct_0`, `RB_0`,
`Blocks_3`, ...). `_Scope` hands out the same names in the same order.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Activation, Conv, ConvBNAct, SegHead
from ..ops.pool import avg_pool_nchw, global_avg_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw

ARCH_HUB = {
    'DDRNet-23-slim': {'init_channel': 32, 'repeat_times': (2, 2, 2, 0, 2, 1)},
    'DDRNet-23': {'init_channel': 64, 'repeat_times': (2, 2, 2, 0, 2, 1)},
    'DDRNet-39': {'init_channel': 64, 'repeat_times': (3, 4, 3, 3, 3, 1)},
}


class _Scope:
    """Registers submodules on `owner` under Flax's auto-names: the class
    name and its count so far in this scope."""

    def __init__(self, owner: nn.Module):
        self.owner, self.counts = owner, {}

    def add(self, module: nn.Module) -> str:
        cls = type(module).__name__
        n = self.counts.get(cls, 0)
        self.counts[cls] = n + 1
        name = f'{cls}_{n}'
        self.owner.add_module(name, module)
        return name


class RB(nn.Module):
    """Residual basic block; its last activation is a ReLU whatever the
    act_type, as in the reference."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.down = stride > 1 or in_channels != out_channels
        self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels, 3, stride,
                                     act_type=act_type, device=device)
        self.ConvBNAct_1 = ConvBNAct(out_channels, out_channels, 3, 1,
                                     act_type='none', device=device)
        if self.down:
            self.ConvBNAct_2 = ConvBNAct(in_channels, out_channels, 1, stride,
                                         act_type='none', device=device)

    def forward(self, x):
        y = self.ConvBNAct_1(self.ConvBNAct_0(x))
        identity = self.ConvBNAct_2(x) if self.down else x
        return torch.relu(y + identity)


class RBB(nn.Module):
    """Residual bottleneck block."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c = in_channels
        self.down = stride > 1 or c != out_channels
        self.ConvBNAct_0 = ConvBNAct(c, c, 1, act_type=act_type,
                                     device=device)
        self.ConvBNAct_1 = ConvBNAct(c, c, 3, stride, act_type=act_type,
                                     device=device)
        self.ConvBNAct_2 = ConvBNAct(c, out_channels, 1, act_type='none',
                                     device=device)
        if self.down:
            self.ConvBNAct_3 = ConvBNAct(c, out_channels, 1, stride,
                                         act_type='none', device=device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, x):
        y = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        identity = self.ConvBNAct_3(x) if self.down else x
        return self.Activation_0(y + identity)


class Blocks(nn.Module):
    """`repeat_times` blocks of one type, the first strided."""

    def __init__(self, block: type, in_channels: int, out_channels: int,
                 stride: int, repeat_times: int, act_type: str, device=None):
        super().__init__()
        scope = _Scope(self)
        self.names = [scope.add(block(in_channels if i == 0 else out_channels,
                                      out_channels, stride if i == 0 else 1,
                                      act_type, device=device))
                      for i in range(repeat_times)]

    def forward(self, x):
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class BilateralFusion(nn.Module):
    def __init__(self, low_channels: int, high_channels: int, stride: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(low_channels, high_channels, 1,
                                     act_type='none', device=device)
        self.ConvBNAct_1 = ConvBNAct(high_channels, low_channels, 3, stride,
                                     act_type='none', device=device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, x_low, x_high):
        fuse_low = self.ConvBNAct_0(x_low)
        fuse_high = self.ConvBNAct_1(x_high)
        x_low = self.Activation_0(x_low + fuse_high)
        fuse_low = resize_bilinear_nchw(fuse_low, x_high.shape[2:4],
                                        align_corners=True)
        return x_low, self.Activation_0(x_high + fuse_low)


class DAPPM(nn.Module):
    # (window, stride) of the pooled branches pool2..pool5; -1 is global
    POOLS = ((5, 2), (9, 4), (17, 8), (-1, -1))

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        hid, a, d = in_channels // 4, act_type, device
        self.conv0 = ConvBNAct(in_channels, out_channels, 1, act_type=a,
                               device=d)
        self.conv1 = ConvBNAct(in_channels, hid, 1, act_type=a, device=d)
        for i in range(len(self.POOLS)):
            setattr(self, f'pool{i + 2}', Conv(in_channels, hid, 1, device=d))
            setattr(self, f'conv{i + 2}',
                    ConvBNAct(hid, hid, 3, act_type=a, device=d))
        self.conv_last = ConvBNAct(hid * (len(self.POOLS) + 1), out_channels,
                                   1, act_type=a, device=d)

    def forward(self, x):
        size = x.shape[2:4]
        y0 = self.conv0(x)
        prev = self.conv1(x)
        ys = [prev]
        for i, (k, s) in enumerate(self.POOLS):
            y = global_avg_pool_nchw(x) if k == -1 else \
                avg_pool_nchw(x, k, s, (k - 1) // 2)
            y = resize_bilinear_nchw(getattr(self, f'pool{i + 2}')(y), size,
                                     align_corners=True)
            prev = getattr(self, f'conv{i + 2}')(prev + y)
            ys.append(prev)
        return self.conv_last(torch.cat(ys, dim=1)) + y0


class DDRNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits
    [B, H, W, C], or the 1/8-resolution logits with `defer_upsample=True`.
    In training with `use_aux` it returns (logits, (aux,)), the aux logits
    NHWC at 1/8."""

    def __init__(self, num_class: int = 1, arch_type: str = 'DDRNet-23-slim',
                 act_type: str = 'relu', use_aux: bool = True,
                 hires_remat: bool = False, device=None):
        super().__init__()
        if arch_type not in ARCH_HUB:
            raise ValueError(f'Unsupport architecture type: {arch_type}.')
        if hires_remat:
            raise NotImplementedError(
                'DDRNet in the PyTorch port does not implement the TPU lever '
                'hires_remat (see ROADMAP.md); unset it')
        ch = ARCH_HUB[arch_type]['init_channel']
        rep = ARCH_HUB[arch_type]['repeat_times']
        a, d = act_type, device
        self.use_aux = use_aux
        scope = _Scope(self)

        def blocks(block, c_in, c_out, stride, n):
            return scope.add(Blocks(block, c_in, c_out, stride, n, a, d))

        # conv1 + stage2 (1/4) + stage3 (1/8), in the JAX order of creation
        self.prefix = [scope.add(ConvBNAct(3, ch, 3, 2, act_type=a, device=d)),
                       scope.add(ConvBNAct(ch, ch, 3, 2, act_type=a,
                                           device=d))]
        self.prefix += [scope.add(RB(ch, ch, 1, a, device=d))
                        for _ in range(rep[0])]
        self.prefix.append(blocks(RB, ch, ch * 2, 2, rep[1]))
        # stage4: low (1/16) and high (1/8) branches, fused once or twice
        self.stage4 = [(blocks(RB, ch * 2, ch * 4, 2, rep[2]),
                        blocks(RB, ch * 2, ch * 2, 1, rep[2]),
                        scope.add(BilateralFusion(ch * 4, ch * 2, 2, a, d)))]
        if rep[3] > 0:
            self.stage4.append((blocks(RB, ch * 4, ch * 4, 1, rep[3]),
                                blocks(RB, ch * 2, ch * 2, 1, rep[3]),
                                scope.add(BilateralFusion(ch * 4, ch * 2, 2,
                                                          a, d))))
        if use_aux:
            self.aux_head = SegHead(ch * 2, num_class, a, device=d)
        # stage5: low to 1/32 then 1/64 and DAPPM; high stays at 1/8
        self.low5 = blocks(RB, ch * 4, ch * 8, 2, rep[4])
        self.high5 = blocks(RB, ch * 2, ch * 2, 1, rep[4])
        self.fuse5 = scope.add(BilateralFusion(ch * 8, ch * 2, 4, a, d))
        self.low6 = blocks(RBB, ch * 8, ch * 16, 2, rep[5])
        self.dappm = scope.add(DAPPM(ch * 16, ch * 4, a, device=d))
        self.high6 = blocks(RBB, ch * 2, ch * 4, 1, rep[5])
        self.seg_head = SegHead(ch * 4, num_class, a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        m = self.get_submodule
        for name in self.prefix:
            x = m(name)(x)
        x_low = x_high = x
        for low, high, fuse in self.stage4:
            x_low, x_high = m(fuse)(m(low)(x_low), m(high)(x_high))
        aux_on = self.training and self.use_aux
        if aux_on:
            x_aux = self.aux_head(x_high)

        x_low, x_h = m(self.fuse5)(m(self.low5)(x_low),
                                   m(self.high5)(x_high))
        x_low = m(self.dappm)(m(self.low6)(x_low))
        x_low = resize_bilinear_nchw(x_low, x_high.shape[2:4],
                                     align_corners=True)
        x = self.seg_head(m(self.high6)(x_h) + x_low)
        x = final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
        if aux_on:
            return x, (x_aux.permute(0, 2, 3, 1),)
        return x
