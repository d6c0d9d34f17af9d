"""Fused head: bilinear-upsample class logits + channel argmax (K1).

Counterpart of rtseg_tpu/ops/fused_head.py. The eval/predict steps call
`resize_argmax` on the model's deferred low-resolution logits, and the
full-resolution [B, H, W, C] logit tensor is never built.

On a CUDA tensor one kernel (ops/csrc/fused_head.cu) reads the NHWC logits
and writes the int32 predictions; nothing else reaches device memory. It
runs on a plan built here on the host (`head_plan`) from the two non-zero
taps of each row of the interpolation operators (`interp_taps`):

  bands   output rows cut into runs that read the same pair of input rows
          (lo, hi); a row's value is lerp(row lo, row hi, a) per class.
  groups  runs of consecutive bands, which share input rows.
  tiles   output columns cut into tiles of `tile_w`; a tile's W-taps lie in
          one window of input columns [ws, ws + nw).

A block takes one (batch, group, tile) and copies the window of the
group's input rows into shared memory. Each thread owns a column: for each
band it W-interpolates the band's two input rows once, and for every
output row does one lerp per class and a running argmax. The window and
the registers hold a bucket of REG_BUCKETS classes (the smallest that takes
C; the classes past C are NaN in the window and never win); above the
largest bucket the kernel reads its taps from the logits directly and
needs no window.

The result equals `argmax(resize_bilinear(x, size))` up to float
associativity on near-ties (float32 arithmetic throughout, on bf16 logits
too); exact ties go to the lowest class index.

On a CPU tensor `resize_argmax` runs its plain version (`_argmax_ref`); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import cuda_build
from .resize import _interp_matrix, _pair, resize_bilinear

MAX_BAND_ROWS = 16      # longer runs of one row pair split, for parallelism
GROUP_BANDS = 4         # consecutive bands a block takes, sharing rows
TILE_W = 64             # output columns a block takes, where the window fits
# register instances of ops/csrc/fused_head.cu: 19 for Cityscapes, and
# buckets for other class counts
REG_BUCKETS = (1, 4, 8, 16, 19, 24, 32)
REG_CLASSES = REG_BUCKETS[-1]
SMEM_LIMIT = 48 * 1024  # a block's window (bytes), below the opt-in limit
_BLOCK_LIMIT = 2 ** 31 - 1      # gridDim.x


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


@dataclass(frozen=True, eq=False)
class HeadPlan:
    """What the kernel is launched with for one (h, w, C) -> (H, W).

    Band k covers output rows [band_start[k], band_start[k+1]) and reads
    input rows band_lo[k] and band_hi[k] (equal, or adjacent); row y's value
    is (1 - row_a[y]) * lo + row_a[y] * hi. Group g is the run of bands
    [group_start[g], group_start[g+1]); it reads the input rows from the
    first band's lo to the last band's hi, at most `group_rows` of them.
    Column x reads input columns col_lo[x] and col_hi[x] with weights
    col_wlo[x], col_whi[x] (exactly `interp_taps`). Tile t covers output
    columns [t*tile_w, (t+1)*tile_w) and reads input columns
    [tile_ws[t], tile_ws[t] + tile_nw[t]), at most `win` of them. A block
    takes one (batch, group, tile) and copies that window of the group's
    rows, every class, into shared memory.
    """
    band_start: np.ndarray
    band_lo: np.ndarray
    band_hi: np.ndarray
    row_a: np.ndarray
    group_start: np.ndarray
    group_rows: int
    col_lo: np.ndarray
    col_hi: np.ndarray
    col_wlo: np.ndarray
    col_whi: np.ndarray
    tile_w: int
    tile_ws: np.ndarray
    tile_nw: np.ndarray
    win: int
    num_class: int

    @property
    def nbands(self) -> int:
        return len(self.band_lo)

    @property
    def ngroups(self) -> int:
        return len(self.group_start) - 1

    @property
    def ntiles(self) -> int:
        return len(self.tile_ws)

    @property
    def threads(self) -> int:
        return max(self.tile_w, 32)

    @property
    def reg_classes(self) -> int:
        return reg_bucket(self.num_class)

    @property
    def smem_bytes(self) -> int:
        return _smem(self.group_rows, self.win, self.num_class)

    def ints(self) -> np.ndarray:
        """The int32 arrays in the order ops/csrc/fused_head.cu unpacks."""
        return np.concatenate([self.band_start, self.band_lo, self.band_hi,
                               self.group_start, self.col_lo, self.col_hi,
                               self.tile_ws, self.tile_nw]).astype(np.int32)

    def floats(self) -> np.ndarray:
        """The float32 arrays in the order ops/csrc/fused_head.cu unpacks."""
        return np.concatenate([self.row_a, self.col_wlo,
                               self.col_whi]).astype(np.float32)


def reg_bucket(C: int) -> int:
    """The kernel's register instance for C classes: the smallest of
    REG_BUCKETS that takes C, or 0 (taps read from the logits) above them."""
    return next((n for n in REG_BUCKETS if n >= C), 0)


def _smem(rows: int, win: int, C: int) -> int:
    """Bytes of the float32 window, at the register bucket's classes a
    pixel; above REG_CLASSES the kernel reads its taps from the logits and
    keeps no window."""
    return rows * win * reg_bucket(C) * 4


def _bands(h: int, H: int, align_corners: bool):
    lo, hi, _, whi = interp_taps(h, H, align_corners)
    # a one-tap row r reads the pair (r, r+1) with weight 0 on r+1, so that
    # it joins the rows after it; (r, r) only at the last input row
    pair_hi = np.where(hi > lo, hi, np.minimum(lo + 1, h - 1)
                       ).astype(np.int32)
    row_a = np.where(hi > lo, whi, 0.0).astype(np.float32)
    start = [0]
    for y in range(1, H):
        if (lo[y], pair_hi[y]) != (lo[y - 1], pair_hi[y - 1]) or \
                y - start[-1] == MAX_BAND_ROWS:
            start.append(y)
    first = np.asarray(start)
    start.append(H)
    return (np.asarray(start, np.int32), lo[first].astype(np.int32),
            pair_hi[first], row_a)


def _groups(band_lo: np.ndarray, band_hi: np.ndarray, size: int):
    nb = len(band_lo)
    first = np.arange(0, nb, size)
    last = np.minimum(first + size, nb) - 1
    rows = int((band_hi[last] - band_lo[first]).max()) + 1
    return np.append(first, nb).astype(np.int32), rows


def _tiles(col_lo: np.ndarray, col_hi: np.ndarray, tile_w: int):
    W = len(col_lo)
    x0 = np.arange(0, W, tile_w)
    ws = np.minimum.reduceat(col_lo, x0).astype(np.int32)
    nw = (np.maximum.reduceat(col_hi, x0) - ws + 1).astype(np.int32)
    return ws, nw, int(nw.max())


@lru_cache(maxsize=64)
def head_plan(h: int, w: int, H: int, W: int, C: int,
              align_corners: bool = True) -> HeadPlan:
    """The host-side plan of the kernel (see `HeadPlan`). While the window
    would not fit in SMEM_LIMIT, groups of GROUP_BANDS bands are halved,
    then tiles of TILE_W columns (one column of one band always fits:
    2 * 2 * REG_CLASSES float32 values)."""
    band_start, band_lo, band_hi, row_a = _bands(h, H, align_corners)
    col_lo, col_hi, col_wlo, col_whi = interp_taps(w, W, align_corners)
    size, tile_w = GROUP_BANDS, TILE_W
    group_start, rows = _groups(band_lo, band_hi, size)
    ws, nw, win = _tiles(col_lo, col_hi, tile_w)
    while _smem(rows, win, C) > SMEM_LIMIT:
        if size > 1:
            size //= 2
            group_start, rows = _groups(band_lo, band_hi, size)
        else:
            tile_w //= 2
            ws, nw, win = _tiles(col_lo, col_hi, tile_w)
    return HeadPlan(band_start, band_lo, band_hi, row_a, group_start, rows,
                    col_lo, col_hi, col_wlo, col_whi, tile_w, ws, nw, win, C)


@lru_cache(maxsize=64)
def _device_plan(h: int, w: int, H: int, W: int, C: int, align_corners: bool,
                 device: torch.device):
    plan = head_plan(h, w, H, W, C, align_corners)
    return (plan, torch.from_numpy(plan.ints()).to(device),
            torch.from_numpy(plan.floats()).to(device))


@lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load('fused_head').rtseg_head_argmax
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resize_argmax(x: torch.Tensor, size, align_corners: bool = True
                  ) -> torch.Tensor:
    """argmax over channels of the bilinear-resized NHWC `x`, as int32
    [B, H, W]; one kernel on CUDA (see the module docstring)."""
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
    if C < 1:
        raise ValueError(f'resize_argmax: shape {tuple(x.shape)} has no '
                         f'classes')
    plan, ints, floats = _device_plan(h, w, H, W, C, bool(align_corners),
                                      x.device)
    blocks = B * plan.ngroups * plan.ntiles
    if blocks > _BLOCK_LIMIT:
        raise ValueError(f'resize_argmax: shape {tuple(x.shape)} -> '
                         f'{(H, W)} needs {blocks} blocks, more than the '
                         f'kernel grid takes')
    out = torch.empty((B, H, W), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _entry()(x.data_ptr(), ints.data_ptr(), floats.data_ptr(),
                  out.data_ptr(), blocks, h, w, C, H, W, plan.nbands,
                  plan.ngroups, plan.ntiles, plan.tile_w, plan.win,
                  plan.threads, plan.smem_bytes, plan.reg_classes,
                  int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(rc, 'fused_head')
    resize_argmax.launches += 1
    return out


resize_argmax.launches = 0
