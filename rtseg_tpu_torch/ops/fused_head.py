"""Fused head: bilinear-upsample class logits + channel argmax (K1).

Counterpart of rtseg_tpu/ops/fused_head.py. The eval/predict steps call
`resize_argmax` on the model's deferred low-resolution logits, and the
full-resolution [B, H, W, C] logit tensor is never built:

  stage 1 (torch.matmul): W-interpolation at low height against the
      `_interp_matrix(w, W)` operator, [B, h, w, C] -> [B, h, C, W], the same
      plain product the JAX package leaves to XLA outside its kernel.
  stage 2 (CUDA, ops/csrc/fused_head.cu): H-interpolation from the two
      non-zero taps of each row of `_interp_matrix(h, H)` and a running
      argmax over classes; only the int32 predictions reach memory.

The result equals `argmax(resize_bilinear(x, size))` up to float
associativity on near-ties; exact ties go to the lowest class index.

On a CPU tensor `resize_argmax` runs its plain version (`_argmax_ref`); on
a CUDA tensor it launches the kernel or raises. Every shape within the CUDA
grid's limits runs the kernel: the TPU kernel's tiling limits and its
materializing fallback have no counterpart here.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import cuda_build
from .resize import _interp_matrix, _pair, interp_operator, resize_bilinear

_GRID_LIMIT = 65535             # gridDim.z (batch) and gridDim.y (H / 8)


def _argmax_ref(x: torch.Tensor, size, align_corners: bool = True
                ) -> torch.Tensor:
    """Plain version: materialize the upsampled logits, then argmax."""
    out = resize_bilinear(x, size, align_corners=align_corners)
    return torch.argmax(out, dim=-1).to(torch.int32)


def interp_taps(in_size: int, out_size: int, align_corners: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The two non-zero taps of each row of `_interp_matrix(in, out)`:
    (lo, hi) int32 and their float32 weights. A row with one non-zero entry
    (an exact source row, the last row among them) gets hi = lo and weight
    0 on hi, so the two-tap sum equals the dense row product."""
    m = _interp_matrix(in_size, out_size, align_corners)
    lo = np.zeros(out_size, np.int32)
    hi = np.zeros(out_size, np.int32)
    wlo = np.zeros(out_size, np.float32)
    whi = np.zeros(out_size, np.float32)
    for y in range(out_size):
        nz = np.flatnonzero(m[y])
        if not 1 <= len(nz) <= 2:
            raise AssertionError(f'row {y} of the interpolation operator '
                                 f'has {len(nz)} non-zero taps')
        lo[y], hi[y] = nz[0], nz[-1]
        wlo[y] = m[y, nz[0]]
        whi[y] = m[y, nz[-1]] if len(nz) == 2 else 0.0
    return lo, hi, wlo, whi


@lru_cache(maxsize=64)
def _device_taps(in_size: int, out_size: int, align_corners: bool,
                 device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in interp_taps(in_size, out_size, align_corners))


@lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load('fused_head').rtseg_head_argmax
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def w_interp(x: torch.Tensor, W: int, align_corners: bool = True
             ) -> torch.Tensor:
    """Stage 1: W-interpolation of NHWC `x` [B, h, w, C] at low height,
    class-major for the kernel: [B, h, C, W] in the type of `x`. One
    [B*h*C, w] x [w, W] product (a batch of C-row products is far slower);
    the reshape copies only the low-resolution logits."""
    B, h, w, C = x.shape
    mw = interp_operator(w, W, align_corners, x.dtype, x.device)
    z = torch.matmul(x.transpose(2, 3).reshape(B * h * C, w), mw.t())
    return z.view(B, h, C, W)


def _launch(z: torch.Tensor, taps, out: torch.Tensor) -> None:
    """Stage 2 on `z` [B, h, C, W] into `out` [B, H, W] int32, on the
    current stream."""
    B, h, C, W = z.shape
    H = out.shape[1]
    lo, hi, wlo, whi = taps
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = _entry()(z.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                  wlo.data_ptr(), whi.data_ptr(), out.data_ptr(),
                  B, h, C, H, W, int(z.dtype == torch.bfloat16), stream)
    cuda_build.check(rc, 'fused_head')


def resize_argmax(x: torch.Tensor, size, align_corners: bool = True
                  ) -> torch.Tensor:
    """argmax over channels of the bilinear-resized NHWC `x`, as int32
    [B, H, W]; fused on CUDA (see the module docstring)."""
    B, h, w, C = x.shape
    H, W = _pair(size)
    if (h, w) == (H, W):
        return torch.argmax(x, dim=-1).to(torch.int32)
    if x.device.type == 'cpu':
        return _argmax_ref(x, size, align_corners)
    if x.device.type != 'cuda':
        raise ValueError(f'resize_argmax: unsupported device {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'resize_argmax: logits must be float32 or '
                        f'bfloat16, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('resize_argmax: logits must be a contiguous NHWC '
                         'tensor')
    if B > _GRID_LIMIT or -(-H // 8) > _GRID_LIMIT or C < 1:
        raise ValueError(f'resize_argmax: shape {tuple(x.shape)} -> '
                         f'{(H, W)} is outside the kernel grid')
    z = w_interp(x, W, align_corners)
    out = torch.empty((B, H, W), dtype=torch.int32, device=x.device)
    _launch(z, _device_taps(h, H, align_corners, x.device), out)
    resize_argmax.launches += 1
    return out


resize_argmax.launches = 0
