"""Align-corners bilinear resize as two products against interpolation
matrices, and the nearest resize of label maps (the counterpart of
rtseg_tpu/ops/resize.py).

The formulation is kept on purpose instead of `F.interpolate`: the two
products round to the working type at the same places as the JAX package
does, so bf16 results agree where the algorithm agrees.

Public functions take NHWC tensors, like the JAX package. Inside the model
the same operators run on NCHW (`resize_bilinear_nchw`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Size2 = Union[int, Tuple[int, int], Sequence[int]]


def _pair(size: Size2) -> Tuple[int, int]:
    if isinstance(size, int):
        return size, size
    return int(size[0]), int(size[1])


@lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool
                   ) -> np.ndarray:
    """Dense (out, in) 1-D linear interpolation operator matching torch
    F.interpolate index math for both align_corners settings."""
    out = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = out * ((in_size - 1) / max(out_size - 1, 1)) if out_size > 1 \
            else np.zeros_like(out)
    else:
        src = np.clip((out + 0.5) * (in_size / out_size) - 0.5, 0.0, None)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    w = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), lo), (1.0 - w))
    np.add.at(m, (np.arange(out_size), hi), w)
    return m


@lru_cache(maxsize=256)
def interp_operator(in_size: int, out_size: int, align_corners: bool,
                    dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`_interp_matrix` as a tensor of `dtype` on `device`, uploaded once
    per signature (callers never write to it). Made outside inference
    mode, so that a matrix first asked for by an eval step can be saved
    for a later training backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(
            in_size, out_size, align_corners)).to(device, dtype)


def resize_bilinear_nchw(x: torch.Tensor, size: Size2,
                         align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of NCHW `x`: H-interpolation, then W-interpolation,
    each a product in the input's type (float32 accumulation)."""
    out_h, out_w = _pair(size)
    h, w = x.shape[2], x.shape[3]
    if (h, w) == (out_h, out_w):
        return x
    mh = interp_operator(h, out_h, align_corners, x.dtype, x.device)
    mw = interp_operator(w, out_w, align_corners, x.dtype, x.device)
    out = torch.matmul(mh, x)                     # (n, c, H, w)
    out = torch.matmul(out, mw.t())               # (n, c, H, W)
    if x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        # keep the model's channels_last layout for the convs that follow
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def resize_bilinear(x: torch.Tensor, size: Size2, align_corners: bool = True
                    ) -> torch.Tensor:
    """Bilinear resize of NHWC `x` to `size` = (H, W); matches torch
    F.interpolate(mode='bilinear') for both align_corners settings."""
    out_h, out_w = _pair(size)
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = resize_bilinear_nchw(x.permute(0, 3, 1, 2), size, align_corners)
    return y.permute(0, 2, 3, 1)


def final_upsample(x: torch.Tensor, size: Size2, align_corners: bool = True,
                   defer: bool = False) -> torch.Tensor:
    """A model's last op on NCHW logits: bilinear upsample to label
    resolution, or with `defer` the low-resolution logits unchanged, for
    the caller's fused upsample+argmax head (ops/fused_head.py)."""
    if defer:
        if align_corners is not True:
            # the fused head re-applies the upsample with align_corners=True
            # unconditionally; deferring another flag would silently change
            # eval semantics
            raise ValueError(
                'final_upsample(align_corners=False) cannot be deferred: '
                'the fused head re-applies align_corners=True. Disable '
                'config.fused_head for this model or extend the deferral '
                'contract to thread the flag.')
        return x
    return resize_bilinear_nchw(x, size, align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size: Size2) -> torch.Tensor:
    """Nearest resize of NHWC `x` (any dtype, label maps included),
    matching torch F.interpolate(mode='nearest') index math:
    src = floor(dst * in / out)."""
    out_h, out_w = _pair(size)
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (out_h, out_w):
        return x
    idx_h = torch.arange(out_h, device=x.device) * h // out_h
    idx_w = torch.arange(out_w, device=x.device) * w // out_w
    return x.index_select(1, idx_h.clamp_(0, h - 1)).index_select(
        2, idx_w.clamp_(0, w - 1))


def resize_nearest_nchw(x: torch.Tensor, size: Size2) -> torch.Tensor:
    """resize_nearest on the NHWC view of NCHW `x`: a channels_last input
    gives a channels_last output."""
    return resize_nearest(x.permute(0, 2, 3, 1), size).permute(0, 3, 1, 2)


def pixel_shuffle_nchw(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """Sub-pixel upsample of NCHW `x` (torch nn.PixelShuffle's order):
    input channel c*r^2 + r1*r + r2 goes to output channel c at spatial
    offset (r1, r2). Written as a reshape and a permute, whose backward is
    the inverse permute. A channels_last input gives a channels_last
    output."""
    r = upscale_factor
    n, crr, h, w = x.shape
    c = crr // (r * r)
    y = x.reshape(n, c, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    y = y.reshape(n, c, h * r, w * r)
    if x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """NHWC counterpart of torch nn.PixelShuffle, as the JAX package's."""
    return pixel_shuffle_nchw(x.permute(0, 3, 1, 2),
                              upscale_factor).permute(0, 2, 3, 1)
