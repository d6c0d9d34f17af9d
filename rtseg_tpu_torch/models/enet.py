"""ENet's initial block (the port of rtseg_tpu/models/enet.py:23-37).

`InitialBlock` is the stem of CFPNet, DABNet, ERFNet, ESNet, FDDWNet,
FSSNet and MiniNetv2 (in several of them the reference calls it a
downsampling block). ENet itself, with its dropout and its argmax max-pool
and unpool, is not ported yet (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import ConvBNAct
from ..ops.pool import max_pool_nchw


class InitialBlock(nn.Module):
    """A stride-2 ConvBNAct to out - in channels, concatenated with
    max_pool(x, 3, 2, 1) of the input: `out_channels` in all."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'prelu', kernel_size: int = 3,
                 device=None):
        super().__init__()
        if out_channels <= in_channels:
            raise ValueError('out_channels should be larger than '
                             'in_channels.')
        self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels - in_channels,
                                     kernel_size, 2, act_type=act_type,
                                     device=device)

    def forward(self, x):
        return torch.cat([self.ConvBNAct_0(x), max_pool_nchw(x, 3, 2, 1)],
                         dim=1)
