"""The uint8 flip+normalize tail of a train or eval step (counterpart of
rtseg_tpu/ops/augment.py).

A loader that ships uint8 HWC batches (the raw tail: 4x fewer bytes to the
card than float32) hands the step per-sample (h_flip, v_flip) draws in a
[B, 2] uint8 plane, and the step opens with this stage. It is bit-equal to
the host path, which flips and then normalizes with two roundings,
f32(f32(v) * scale) + bias:

  * the flips are permutations (torch.flip under a per-sample where);
  * the normalize is a gather of a [256 * C] float32 table built on the
    host with the host's two roundings. A multiply-add on the device may
    be contracted into one fused rounding and differ by an ulp; a uint8
    input makes the normalize a function of 256 values a channel, so the
    gather does no float arithmetic on the device at all.

The functions take tensors on any device; the train and eval steps build
the table once a device (`norm_table`) and call `flip_norm` /
`normalize` with it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _norm_lut(scale, bias) -> np.ndarray:
    """[256, C] float32 table: lut[v, c] is the host normalize of value v
    in channel c, with the host's two roundings (out = x.astype(f32);
    out *= scale; out += bias)."""
    v = np.arange(256, dtype=np.float32)[:, None]
    lut = v * np.asarray(scale, np.float32)
    lut += np.asarray(bias, np.float32)
    return lut


def norm_table(scale: Sequence[float], bias: Sequence[float],
               device) -> torch.Tensor:
    """The flat [256 * C] float32 table of (scale, bias) on `device`."""
    return torch.from_numpy(_norm_lut(scale, bias).reshape(-1)).to(device)


def normalize(images: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """uint8 [..., C] -> float32 [..., C] through `table` (`norm_table`).
    Only uint8 has a table: a float batch raises (the JAX package's
    float fallback serves no path, and its multiply-add is not the host's
    arithmetic)."""
    if images.dtype != torch.uint8:
        raise TypeError(f'the normalize by table takes uint8 images, got '
                        f'{images.dtype}')
    c = images.shape[-1]
    idx = images.to(torch.int32) * c + torch.arange(
        c, dtype=torch.int32, device=images.device)
    return table.index_select(0, idx.reshape(-1)).view(images.shape)


def _flip(x: torch.Tensor, flag: torch.Tensor, dim: int) -> torch.Tensor:
    """x with the samples whose flag is set reversed along `dim`."""
    keep = flag.to(torch.bool).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x.flip(dim), x)


def flip_norm(images: torch.Tensor, masks: torch.Tensor,
              flags: torch.Tensor, table: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample flips, then the normalize through `table`.

    images [B, H, W, C] uint8 and masks [B, H, W] as the loader made them
    (not flipped, not normalized); flags [B, 2] uint8, (h_flip, v_flip).
    The flips run on the uint8 plane, in the host's order, flip then
    normalize (the two commute exactly). Returns the float32 images and
    the flipped masks."""
    x = _flip(_flip(images, flags[:, 0], 2), flags[:, 1], 1)
    m = _flip(_flip(masks, flags[:, 0], 2), flags[:, 1], 1)
    return normalize(x, table), m


def device_normalize(images: torch.Tensor, scale, bias) -> torch.Tensor:
    """uint8 HWC batch -> normalized float32, bit-equal to the host
    normalize (the eval transform never flips)."""
    return normalize(images, norm_table(scale, bias, images.device))


def device_flip_norm(images: torch.Tensor, masks: torch.Tensor,
                     flags: torch.Tensor, scale, bias
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flip_norm` with the table of (scale, bias): the JAX package's
    signature."""
    return flip_norm(images, masks, flags,
                     norm_table(scale, bias, images.device))
