"""Segmentation losses (counterpart of rtseg_tpu/losses/losses.py:
cross_entropy, ohem_cross_entropy, the STDC detail loss and the Laplacian
pyramid of its ground truth).

Inputs are NHWC logits [B, H, W, C] (bf16 or float32) and integer labels
[B, H, W]. Both losses compute a float32 log-softmax and follow the JAX
package's arithmetic, so the port's training loss is the JAX package's:

  * cross_entropy has torch nn.CrossEntropyLoss semantics: ignored pixels
    add nothing, and the mean divides by the summed weight of the
    non-ignored pixels (at least 1e-8). A label outside [0, C) that is not
    ignored adds a zero loss, as the JAX package's one-hot does.
  * ohem_cross_entropy keeps a pixel when its loss is above -log(thresh)
    or it is among the n_valid // 16 hardest. Up to 2^18 pixels the rank
    comes from one stable descending sort (ties, every ignored pixel's 0
    among them, keep index order, as jnp.argsort does). Above, 16 steps of
    a bisection find a threshold at or below the n_min-th largest loss and
    keep every pixel at or above it (at least n_min). The bisection runs on
    the device: no value is read back to the host.
  * detail_loss is dice (on raw logits, as the reference computes it) plus
    binary cross-entropy with logits, both in float32.
  * kd_loss is the distillation term: the JAX package's formula for
    'kl_div' written out (F.kl_div treats zero probabilities otherwise),
    or the plain mean squared difference of the logits ('mse').
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_nearest

# above this many pixels the exact rank sort gives way to the bisection,
# as in the JAX package (the two branches must switch at the same size for
# the losses to agree)
_OHEM_SORT_LIMIT = 1 << 18
_OHEM_BISECT_ITERS = 16


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255,
                  class_weights: Optional[Union[torch.Tensor,
                                                Sequence[float]]] = None,
                  reduction: str = 'mean') -> torch.Tensor:
    """Per-pixel CE with the ignore_index semantics of torch
    nn.CrossEntropyLoss; reduction 'none' returns the per-pixel float32
    losses (0 where ignored)."""
    num_class = logits.shape[-1]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    in_range = (safe >= 0) & (safe < num_class)
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, safe.clamp(0, num_class - 1)[..., None])[..., 0]
    nll = torch.where(in_range, -picked, 0.0)
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32,
                             device=logits.device)
        w = torch.where(in_range, cw[safe.clamp(0, num_class - 1)], 0.0)
    else:
        w = torch.ones_like(nll)
    nll = torch.where(valid, nll * w, 0.0)
    if reduction == 'none':
        return nll
    if reduction == 'sum':
        return nll.sum()
    denom = torch.clamp_min(torch.where(valid, w, 0.0).sum(), 1e-8)
    return nll.sum() / denom


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       thresh: float = 0.7, n_min_divisor: int = 16,
                       ignore_index: int = 255) -> torch.Tensor:
    """Online hard example mining CE: the mean loss over the pixels kept
    by the rule of the module docstring."""
    loss_thresh = float(-np.log(np.float32(thresh)))
    valid = (labels != ignore_index).reshape(-1)
    pix = cross_entropy(logits, labels, ignore_index,
                        reduction='none').reshape(-1)
    n_min = valid.sum() // n_min_divisor
    if pix.shape[0] <= _OHEM_SORT_LIMIT:
        order = torch.argsort(-pix.detach(), stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(pix.shape[0], device=pix.device)
        hard = rank < n_min
    else:
        # invariant: count(valid & pix >= lo) >= n_min (at lo = 0 it is
        # n_valid); hi shrinks toward the n_min-th largest loss
        p = pix.detach()
        hi = torch.where(valid, p, 0.0).max()
        lo = torch.zeros_like(hi)
        for _ in range(_OHEM_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            ok = (valid & (p >= mid)).sum() >= n_min
            lo = torch.where(ok, mid, lo)
            hi = torch.where(ok, hi, mid)
        hard = p >= lo
    keep = valid & ((pix.detach() > loss_thresh) | hard)
    cnt = torch.clamp_min(keep.sum(), 1)
    return torch.where(keep, pix, 0.0).sum() / cnt


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Dice per sample over the raw logits (not probabilities), averaged
    over the batch."""
    b = logits.shape[0]
    p = logits.float().reshape(b, -1)
    t = targets.float().reshape(b, -1)
    inter = (p * t).sum(dim=1)
    per = 1.0 - (2.0 * inter + smooth) / (p.sum(dim=1) + t.sum(dim=1)
                                          + smooth)
    return per.mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    x, t = logits.float(), targets.float()
    return torch.mean(torch.clamp_min(x, 0) - x * t
                      + torch.log1p(torch.exp(-torch.abs(x))))


def detail_loss(logits: torch.Tensor, targets: torch.Tensor,
                dice_coef: float = 1.0, bce_coef: float = 1.0
                ) -> torch.Tensor:
    """STDC detail head loss: dice + BCE."""
    return (dice_coef * dice_loss(logits, targets)
            + bce_coef * bce_with_logits(logits, targets))


_LAPLACIAN = ((-1., -1., -1.), (-1., 8., -1.), (-1., -1., -1.))


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            kd_type: str = 'kl_div', temperature: float = 4.0
            ) -> torch.Tensor:
    """Distillation loss over NHWC logits, in float32. 'mse': the mean of
    the squared differences. Any other type, as in the JAX package:
    T^2 * mean(softmax(t/T) * (log(clip(softmax(t/T), 1e-12))
    - log_softmax(s/T))), the mean over every element, the class axis
    included (torch F.kl_div's 'mean' reduction, which the reference
    uses)."""
    s = student_logits.float()
    t = teacher_logits.float()
    if kd_type == 'mse':
        return torch.mean((s - t) ** 2)
    T = temperature
    log_s = F.log_softmax(s / T, dim=-1)
    p_t = F.softmax(t / T, dim=-1)
    pointwise = p_t * (torch.log(torch.clamp(p_t, min=1e-12)) - log_s)
    return (T * T) * torch.mean(pointwise)


def laplacian_pyramid(masks: torch.Tensor) -> torch.Tensor:
    """The fixed 3x3 Laplacian of the float label map (ignore pixels
    included) at strides 1, 2 and 4 with padding 1, the strided ones
    nearest-resized back: [B, H, W] int -> [B, H, W, 3] float32. Integer
    arithmetic in float32, so exact on any device."""
    x = masks.float()[:, None]                                # B,1,H,W
    k = torch.tensor(_LAPLACIAN, device=x.device).reshape(1, 1, 3, 3)
    h, w = x.shape[2], x.shape[3]
    chans = []
    for stride in (1, 2, 4):
        y = F.conv2d(x, k, stride=stride, padding=1).permute(0, 2, 3, 1)
        chans.append(resize_nearest(y, (h, w)))
    return torch.cat(chans, dim=-1)
