"""SegNet (arXiv:1511.00561), the port of rtseg_tpu/models/segnet.py.

A VGG-like encoder of five stages, each ending in a 2x2 max pool that
keeps its argmax (ops/pool.py, int8 index maps), a mirrored decoder that
unpools into them, and a 3x3 ConvBNAct to the classes at full size: the
eval step takes the plain argmax and K1 is never launched. Submodules
carry the Flax scope names.

`pack_fullres` (config.segnet_pack) is the JAX package's packed
space-to-depth layout of the full-resolution stages for the TPU's lanes
(ops/s2d.py, nn/packed.py); the port raises ValueError for it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import ConvBNAct
from ..ops.pool import max_pool_argmax_2x2_nchw, max_unpool_2x2_nchw


class DownsampleBlock(nn.Module):
    """Two (or three) 3x3 ConvBNActs, then the 2x2 argmax pool: returns
    (values, index map)."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', extra_conv: bool = False,
                 device=None):
        super().__init__()
        c, a, d = out_channels, act_type, device
        self.n = 3 if extra_conv else 2
        for i in range(self.n):
            setattr(self, f'ConvBNAct_{i}',
                    ConvBNAct(in_channels if i == 0 else c, c, 3,
                              act_type=a, device=d))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'ConvBNAct_{i}')(x)
        return max_pool_argmax_2x2_nchw(x)


class UpsampleBlock(nn.Module):
    """The 2x2 unpool into the index map, then 3x3 ConvBNActs: in -> in
    -> out, or in -> in -> in -> out with `extra_conv`."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', extra_conv: bool = False,
                 device=None):
        super().__init__()
        c, a, d = in_channels, act_type, device
        hid = c if extra_conv else out_channels
        chans = [(c, c), (c, hid)] + ([(hid, out_channels)] if extra_conv
                                      else [])
        self.n = len(chans)
        for i, (cin, cout) in enumerate(chans):
            setattr(self, f'ConvBNAct_{i}',
                    ConvBNAct(cin, cout, 3, act_type=a, device=d))

    def forward(self, x, indices):
        x = max_unpool_2x2_nchw(x, indices)
        for i in range(self.n):
            x = getattr(self, f'ConvBNAct_{i}')(x)
        return x


class SegNet(nn.Module):
    """Takes NHWC images [B, H, W, 3] (H, W multiples of 32) and returns
    NHWC class logits [B, H, W, C] at full size (also with
    `defer_upsample=True`)."""

    def __init__(self, num_class: int = 1, hid_channel: int = 64,
                 act_type: str = 'relu', pack_fullres: bool = False,
                 device=None):
        super().__init__()
        if pack_fullres:
            raise ValueError(
                'SegNet pack_fullres (config.segnet_pack) is the TPU\'s '
                'packed space-to-depth layout; the port does not build it')
        h, a, d = hid_channel, act_type, device
        down = ((3, h, False), (h, h * 2, False), (h * 2, h * 4, True),
                (h * 4, h * 8, True), (h * 8, h * 8, True))
        up = ((h * 8, h * 8, True), (h * 8, h * 4, True),
              (h * 4, h * 2, True), (h * 2, h, False), (h, h, False))
        for i, (cin, cout, extra) in enumerate(down):
            setattr(self, f'DownsampleBlock_{i}',
                    DownsampleBlock(cin, cout, a, extra, device=d))
        for i, (cin, cout, extra) in enumerate(up):
            setattr(self, f'UpsampleBlock_{i}',
                    UpsampleBlock(cin, cout, a, extra, device=d))
        self.ConvBNAct_0 = ConvBNAct(h, num_class, 3, act_type=a, device=d)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        indices = []
        for i in range(5):
            x, idx = getattr(self, f'DownsampleBlock_{i}')(x)
            indices.append(idx)
        for i in range(5):
            x = getattr(self, f'UpsampleBlock_{i}')(x, indices.pop())
        return self.ConvBNAct_0(x).permute(0, 2, 3, 1)
