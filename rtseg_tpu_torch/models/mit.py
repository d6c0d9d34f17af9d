"""MixTransformer (SegFormer MiT-b0..b5) encoder, the port of
rtseg_tpu/models/mit.py.

Four stages of an overlapping patch embedding (a strided conv and a
LayerNorm), blocks of spatially-reduced self-attention and a Mix-FFN
(a depth-wise 3x3 between two projections), and a LayerNorm a stage; the
stage features come at strides 4, 8, 16 and 32.

Tokens stay NHWC between the projections, which act on the last axis, and
the convs see their NCHW view (a permuted NHWC tensor is channels_last).
The projections run as Flax's Dense with `dtype=x.dtype` does: in the
activation type (`nn/modules.py::dense_as_input`), so bf16 stays bf16.

Attention is computed as the JAX package computes it, with stock
products: q.k^T, divided by sqrt(head width) in the activation type,
softmax over the keys, then .v. Where the attention map of one call would
hold more than `ATTENTION_CHUNK` elements (the first stage at 1024x2048
holds 4.3 G at bs16), the queries are taken in slices of rows; each row's
softmax is its own, so the split is exact.

Drop path (stochastic depth, per sample) follows the linear schedule over
the whole depth; its keep masks come from the mask source bound for the
training forward, as Dropout's do (`nn/modules.py::DropPath`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..nn import Conv, DropPath, LayerNorm, dense_as_input

# dims, depths; heads/sr/mlp-ratio are shared by every variant
MIT_SETTINGS = {
    'mit_b0': ((32, 64, 160, 256), (2, 2, 2, 2)),
    'mit_b1': ((64, 128, 320, 512), (2, 2, 2, 2)),
    'mit_b2': ((64, 128, 320, 512), (3, 4, 6, 3)),
    'mit_b3': ((64, 128, 320, 512), (3, 4, 18, 3)),
    'mit_b4': ((64, 128, 320, 512), (3, 8, 27, 3)),
    'mit_b5': ((64, 128, 320, 512), (3, 6, 40, 3)),
}
MIT_HEADS = (1, 2, 5, 8)
MIT_SR = (8, 4, 2, 1)
MIT_MLP_RATIO = 4
MIT_DROP_PATH = 0.1

# the most elements of one attention map computed at once (a call's
# batch x heads x queries x keys); larger maps are taken in query slices
ATTENTION_CHUNK = 1 << 28


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int = ATTENTION_CHUNK) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [n, heads, tokens, d] tensors, in
    their type, the scale rounded to that type first as JAX rounds
    `sqrt(asarray(d, dtype))`; queries in slices of rows where a map would
    pass `chunk` elements. A symbolic batch (torch.export with a dynamic
    batch) sizes the slices for one sample, so that the exported program's
    slices do not depend on the batch it is called at."""
    n, heads, nq, d = q.shape
    scale = torch.tensor(float(d), dtype=q.dtype).sqrt().item()
    if isinstance(n, torch.SymInt):
        n = 1
    rows = max(1, chunk // max(1, n * heads * k.shape[2]))

    def part(qs):
        att = torch.matmul(qs, k.transpose(-1, -2)) / scale
        return torch.matmul(torch.softmax(att, dim=-1), v)

    if nq <= rows:
        return part(q)
    return torch.cat([part(q[:, :, i:i + rows]) for i in range(0, nq, rows)],
                     dim=2)


class OverlapPatchEmbed(nn.Module):
    """A strided conv (kernel `patch`, padding patch // 2) and a LayerNorm:
    NCHW in, NHWC tokens out."""

    def __init__(self, in_channels: int, dim: int, patch: int, stride: int,
                 device=None):
        super().__init__()
        self.proj = Conv(in_channels, dim, patch, stride, padding=patch // 2,
                         use_bias=True, device=device)
        self.LayerNorm_0 = LayerNorm(dim, device=device)

    def forward(self, x):
        return self.LayerNorm_0(_nhwc(self.proj(x)))


class EfficientSelfAttention(nn.Module):
    """Attention with K and V from an sr x sr strided conv of the token
    grid (and a LayerNorm), Q at full resolution; q, k, v and the output
    projection are Dense layers in the activation type."""

    def __init__(self, dim: int, heads: int, sr: int, device=None):
        super().__init__()
        self.dim, self.heads, self.reduction = dim, heads, sr
        self.q = nn.Linear(dim, dim, device=device)
        if sr > 1:
            self.sr = Conv(dim, dim, sr, sr, padding=0, use_bias=True,
                           device=device)
            self.sr_ln = LayerNorm(dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        n, h, w, c = x.shape
        heads, dh = self.heads, self.dim // self.heads
        q = dense_as_input(x, self.q).reshape(n, h * w, heads, dh)
        kv = x
        if self.reduction > 1:
            kv = self.sr_ln(_nhwc(self.sr(_nchw(x))))
        m = kv.shape[1] * kv.shape[2]
        k = dense_as_input(kv, self.k).reshape(n, m, heads, dh)
        v = dense_as_input(kv, self.v).reshape(n, m, heads, dh)
        out = attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))
        out = out.transpose(1, 2).reshape(n, h, w, self.dim)
        return dense_as_input(out, self.proj)


class MixFFN(nn.Module):
    """fc1 -> depth-wise 3x3 over the token grid -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.dw = Conv(hidden, hidden, 3, groups=hidden, use_bias=True,
                       device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        x = _nhwc(self.dw(_nchw(dense_as_input(x, self.fc1))))
        x = torch.nn.functional.gelu(x, approximate='none')
        return dense_as_input(x, self.fc2)


class Block(nn.Module):
    """Pre-norm attention and Mix-FFN, each on a drop-path residual."""

    def __init__(self, dim: int, heads: int, sr: int, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = EfficientSelfAttention(dim, heads, sr, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.ffn = MixFFN(dim, dim * MIT_MLP_RATIO, device=device)
        self.drop_attn = DropPath(drop_path)
        self.drop_ffn = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_attn(self.attn(self.ln1(x)))
        return x + self.drop_ffn(self.ffn(self.ln2(x)))


class MixTransformer(nn.Module):
    """Takes NCHW images and returns the four stage features at strides
    4, 8, 16 and 32, NCHW (channels_last)."""

    def __init__(self, arch: str = 'mit_b0',
                 drop_path_rate: float = MIT_DROP_PATH, device=None):
        super().__init__()
        if arch not in MIT_SETTINGS:
            raise ValueError(f'Unsupported MixTransformer: {arch}')
        dims, depths = MIT_SETTINGS[arch]
        self.depths = depths
        total = sum(depths)
        # the linear drop-path schedule over the whole depth
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        bi, in_c = 0, 3
        for s in range(4):
            patch, stride = (7, 4) if s == 0 else (3, 2)
            setattr(self, f'patch_embed{s + 1}', OverlapPatchEmbed(
                in_c, dims[s], patch, stride, device=device))
            for j in range(depths[s]):
                setattr(self, f'block{s + 1}_{j}', Block(
                    dims[s], MIT_HEADS[s], MIT_SR[s], dpr[bi],
                    device=device))
                bi += 1
            setattr(self, f'norm{s + 1}', LayerNorm(dims[s], device=device))
            in_c = dims[s]
        self.channels = tuple(dims)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        feats = []
        for s in range(4):
            x = getattr(self, f'patch_embed{s + 1}')(x)
            for j in range(self.depths[s]):
                x = getattr(self, f'block{s + 1}_{j}')(x)
            x = _nchw(getattr(self, f'norm{s + 1}')(x))
            feats.append(x)
        return tuple(feats)
