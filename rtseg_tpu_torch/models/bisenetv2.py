"""BiSeNet V2 (arXiv:2004.02147), the port of rtseg_tpu/models/bisenetv2.py.

Detail branch (three stride-2 stages to 1/8), semantic branch (stem and
gather-expansion stages to 1/32 plus context embedding), bilateral guided
aggregation with sigmoid gates, SegHead and the final align-corners
upsample. Submodules carry the Flax scope names of the JAX model, so
utils/convert.py maps weights path for path.

With `use_aux`, the training forward (`model.train()`) also returns the
logits of the four aux heads `seg_head2..5` (1/4, 1/8, 1/16, 1/32 of the
input), as the JAX model does with `train=True`; in eval they are not
computed. The TPU-only layout levers (`pack_fullres`, `s2d_stem`,
`detail_remat`, `hires_remat`) are refused.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import (Activation, BatchNorm, Conv, ConvBNAct, DWConvBNAct,
                  PWConvBNAct, SegHead)
from ..ops.pool import avg_pool_nchw, global_avg_pool_nchw, max_pool_nchw
from ..ops.resize import final_upsample, resize_bilinear_nchw


class StemBlock(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 16,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, a = out_channels, act_type
        self.ConvBNAct_0 = ConvBNAct(in_channels, c, 3, 2, act_type=a,
                                     device=device)
        self.ConvBNAct_1 = ConvBNAct(c, c // 2, 1, act_type=a, device=device)
        self.ConvBNAct_2 = ConvBNAct(c // 2, c, 3, 2, act_type=a,
                                     device=device)
        self.ConvBNAct_3 = ConvBNAct(2 * c, c, 3, 1, act_type=a,
                                     device=device)

    def forward(self, x):
        x = self.ConvBNAct_0(x)
        left = self.ConvBNAct_2(self.ConvBNAct_1(x))
        right = max_pool_nchw(x, 3, 2, 1)
        return self.ConvBNAct_3(torch.cat([left, right], dim=1))


class GatherExpansionLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act_type: str = 'relu', expand_ratio: int = 6, device=None):
        super().__init__()
        in_c = in_channels
        hid = int(round(in_c * expand_ratio))
        self.stride = stride
        self.ConvBNAct_0 = ConvBNAct(in_c, in_c, 3, act_type=act_type,
                                     device=device)
        if stride == 2:
            self.DWConvBNAct_0 = DWConvBNAct(in_c, hid, 3, 2,
                                             act_type='none', device=device)
            self.DWConvBNAct_1 = DWConvBNAct(hid, hid, 3, 1,
                                             act_type='none', device=device)
            self.DWConvBNAct_2 = DWConvBNAct(in_c, in_c, 3, 2,
                                             act_type='none', device=device)
            self.PWConvBNAct_1 = PWConvBNAct(in_c, out_channels,
                                             act_type='none', device=device)
        else:
            self.DWConvBNAct_0 = DWConvBNAct(in_c, hid, 3, 1,
                                             act_type='none', device=device)
        self.PWConvBNAct_0 = PWConvBNAct(hid, out_channels, act_type='none',
                                         device=device)
        self.Activation_0 = Activation(act_type, device)

    def forward(self, x):
        y = self.ConvBNAct_0(x)
        y = self.DWConvBNAct_0(y)
        if self.stride == 2:
            y = self.DWConvBNAct_1(y)
        y = self.PWConvBNAct_0(y)
        if self.stride == 2:
            res = self.PWConvBNAct_1(self.DWConvBNAct_2(x))
        else:
            res = x
        return self.Activation_0(res + y)


class ContextEmbeddingBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 act_type: str = 'relu', device=None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_channels, device)
        self.ConvBNAct_0 = ConvBNAct(in_channels, in_channels, 1,
                                     act_type=act_type, device=device)
        self.Conv_0 = Conv(in_channels, out_channels, 3, device=device)

    def forward(self, x):
        res = self.BatchNorm_0(global_avg_pool_nchw(x))      # (N, C, 1, 1)
        res = self.ConvBNAct_0(res)
        return self.Conv_0(res + x)                          # broadcast H, W


class DetailBranch(nn.Module):
    SPECS = ((64, 2), (64, 1), (64, 2), (64, 1), (128, 1), (128, 2),
             (128, 1))

    def __init__(self, in_channels: int = 3, out_channels: int = 128,
                 act_type: str = 'relu', device=None):
        super().__init__()
        specs = self.SPECS + ((out_channels, 1),)
        c_in = in_channels
        for i, (c, s) in enumerate(specs):
            setattr(self, f'ConvBNAct_{i}',
                    ConvBNAct(c_in, c, 3, s, act_type=act_type,
                              device=device))
            c_in = c
        self.n = len(specs)

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'ConvBNAct_{i}')(x)
        return x


class SemanticBranch(nn.Module):
    # (out_channels, stride) of the eight gather-expansion layers; an aux
    # head follows the layers whose index is a key of AUX_AFTER
    GE_SPECS = ((32, 2), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1),
                (128, 1), (128, 1))
    AUX_AFTER = {1: 'seg_head3', 3: 'seg_head4', 7: 'seg_head5'}

    def __init__(self, in_channels: int = 3, out_channels: int = 128,
                 num_class: int = 1, act_type: str = 'relu',
                 use_aux: bool = False, device=None):
        super().__init__()
        a = act_type
        self.use_aux = use_aux
        self.StemBlock_0 = StemBlock(in_channels, 16, a, device=device)
        if use_aux:
            self.seg_head2 = SegHead(16, num_class, a, device=device)
        c_in = 16
        for i, (c, s) in enumerate(self.GE_SPECS):
            setattr(self, f'GatherExpansionLayer_{i}',
                    GatherExpansionLayer(c_in, c, s, a, device=device))
            if use_aux and i in self.AUX_AFTER:
                setattr(self, self.AUX_AFTER[i],
                        SegHead(c, num_class, a, device=device))
            c_in = c
        self.ContextEmbeddingBlock_0 = ContextEmbeddingBlock(
            c_in, out_channels, a, device=device)

    def forward(self, x):
        """(features, aux logits): the aux heads run only in training."""
        aux_on = self.training and self.use_aux
        x = self.StemBlock_0(x)                                  # 1/4
        aux = [self.seg_head2(x)] if aux_on else []
        for i in range(len(self.GE_SPECS)):                      # to 1/32
            x = getattr(self, f'GatherExpansionLayer_{i}')(x)
            if aux_on and i in self.AUX_AFTER:
                aux.append(getattr(self, self.AUX_AFTER[i])(x))
        return self.ContextEmbeddingBlock_0(x), aux


class BilateralGuidedAggregationLayer(nn.Module):
    def __init__(self, in_channels: int = 128, out_channels: int = 128,
                 act_type: str = 'relu', device=None):
        super().__init__()
        c, a = in_channels, act_type
        self.DWConvBNAct_0 = DWConvBNAct(c, c, 3, act_type=a, device=device)
        self.Conv_0 = Conv(c, c, 1, device=device)
        self.DWConvBNAct_1 = DWConvBNAct(c, c, 3, 2, act_type=a,
                                         device=device)
        self.ConvBNAct_0 = ConvBNAct(c, c, 3, act_type=a, device=device)
        self.DWConvBNAct_2 = DWConvBNAct(c, c, 3, act_type=a, device=device)
        self.Conv_1 = Conv(c, c, 1, device=device)
        self.ConvBNAct_1 = ConvBNAct(c, out_channels, 3, act_type=a,
                                     device=device)

    def forward(self, x_d, x_s):
        d_high = self.Conv_0(self.DWConvBNAct_0(x_d))
        d_low = avg_pool_nchw(self.DWConvBNAct_1(x_d), 3, 2, 1)
        s_high = resize_bilinear_nchw(self.ConvBNAct_0(x_s),
                                      d_high.shape[2:4], align_corners=True)
        s_high = torch.sigmoid(s_high)
        s_low = torch.sigmoid(self.Conv_1(self.DWConvBNAct_2(x_s)))
        high = d_high * s_high
        low = resize_bilinear_nchw(d_low * s_low, high.shape[2:4],
                                   align_corners=True)
        return self.ConvBNAct_1(high + low)


class BiSeNetv2(nn.Module):
    """Takes NHWC images [B, H, W, 3] and returns NHWC class logits:
    [B, H, W, C], or the low-resolution [B, H/8, W/8, C] with
    `defer_upsample=True` (for the fused head, ops/fused_head.py). In
    training with `use_aux` it returns (logits, (aux2, aux3, aux4, aux5)),
    each aux NHWC at its head's resolution."""

    def __init__(self, num_class: int = 1, act_type: str = 'relu',
                 use_aux: bool = True, detail_remat: bool = False,
                 pack_fullres: bool = False, hires_remat: bool = False,
                 s2d_stem: bool = False, device=None):
        super().__init__()
        levers = {'detail_remat': detail_remat, 'pack_fullres': pack_fullres,
                  'hires_remat': hires_remat, 's2d_stem': s2d_stem}
        on = sorted(k for k, v in levers.items() if v)
        if on:
            raise NotImplementedError(
                f'BiSeNetv2 in the PyTorch port does not implement the '
                f'TPU layout levers {on} (see ROADMAP.md); unset them')
        self.num_class = num_class
        self.use_aux = use_aux
        self.DetailBranch_0 = DetailBranch(3, 128, act_type, device=device)
        self.SemanticBranch_0 = SemanticBranch(3, 128, num_class, act_type,
                                               use_aux, device=device)
        self.BilateralGuidedAggregationLayer_0 = \
            BilateralGuidedAggregationLayer(128, 128, act_type,
                                            device=device)
        self.SegHead_0 = SegHead(128, num_class, act_type, device=device)

    def forward(self, x: torch.Tensor, defer_upsample: bool = False):
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x_d = self.DetailBranch_0(x)
        x_s, aux = self.SemanticBranch_0(x)
        x = self.BilateralGuidedAggregationLayer_0(x_d, x_s)
        x = self.SegHead_0(x)
        x = final_upsample(x, size, defer=defer_upsample).permute(0, 2, 3, 1)
        if aux:
            return x, tuple(a.permute(0, 2, 3, 1) for a in aux)
        return x
