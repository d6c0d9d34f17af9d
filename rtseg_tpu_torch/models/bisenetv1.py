"""The attention modules of BiSeNet V1 (arXiv:1808.00897), ported from
rtseg_tpu/models/bisenetv1.py: the attention refinement module and the
feature fusion module, which STDC shares. The BiSeNetv1 model itself needs
the ResNet context path of models/backbone.py and is not ported yet
(ROADMAP.md Queue 1 item 4).

Both modules gate a feature map with channel attention computed from its
global average. The JAX modules broadcast the pooled map back to full size
before their 1x1 convs; these run the convs on the pooled [B, C, 1, 1] map
and broadcast in the product, which gives the same values: a 1x1 conv is
pointwise, and a BatchNorm over a broadcast map sees each sample's value
H*W times, so its mean and biased variance are those of the B pooled
values. The pooled form sums in another order; it holds STDC's Flax twin
within 1e-4 over three float32 training steps
(tests/test_torch_zoo_train.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Conv, ConvBNAct
from ..ops.pool import global_avg_pool_nchw


class AttentionRefinementModule(nn.Module):
    """x * sigmoid(ConvBN(global average of x))."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(channels, channels, 1,
                                     act_type='sigmoid', device=device)

    def forward(self, x):
        return x * self.ConvBNAct_0(global_avg_pool_nchw(x))


class FeatureFusionModule(nn.Module):
    """concat -> 3x3 ConvBNAct -> x + x * sigmoid(att2(relu(att1(global
    average))))."""

    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_channels, out_channels, 3,
                                     act_type=act_type, device=device)
        self.att1 = Conv(out_channels, out_channels, 1, device=device)
        self.att2 = Conv(out_channels, out_channels, 1, device=device)

    def forward(self, x_low, x_high):
        x = self.ConvBNAct_0(torch.cat([x_low, x_high], dim=1))
        gate = torch.relu(self.att1(global_avg_pool_nchw(x)))
        return x + x * torch.sigmoid(self.att2(gate))
