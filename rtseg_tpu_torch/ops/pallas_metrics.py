"""Evaluation confusion matrix as a CUDA histogram kernel (K2).

Counterpart of rtseg_tpu/ops/pallas_metrics.py (the module keeps its name
so the two packages map path for path). The kernel is
ops/csrc/confusion_matrix.cu; its plain version is
`utils.metrics.confusion_matrix` (a bincount). The kernel counts with
integer atomics, so it is bit-equal to the plain version. `k2_plan` is its
launch plan: how the maps are cut into a scalar head, per-block chunks of
16-byte vectors and a scalar tail, and how many blocks share an SM.

On CPU tensors `confusion_matrix_pallas` runs the plain version; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from ..utils.metrics import confusion_matrix as confusion_matrix_plain
from . import cuda_build

_THREADS = 512          # kThreads in confusion_matrix.cu
_VEC = 4                # int32 pixels in a 16-byte vector
_VECS = 4               # vectors of each map a thread loads an iteration
_CHUNK_ALIGN = 32       # chunks start on 512-byte boundaries of the body
_SMEM_RESERVED = 1024   # shared memory the card reserves for each block


class K2Plan(NamedTuple):
    """Launch plan of the confusion-matrix kernel for one call."""
    grid: int           # blocks (at most two an SM)
    chunk: int          # vectors of the body a block walks
    head: int           # scalar pixels before the 16-byte aligned body
    nvec: int           # 4-pixel vectors in the body
    tail: int           # scalar pixels after it
    vec: bool           # 128-bit loads (both maps share their alignment)
    smem: int           # bytes of dynamic shared memory a block


@lru_cache(maxsize=256)
def k2_plan(n: int, label_offset: int, pred_offset: int, num_class: int,
            sms: int, smem_block: int, smem_sm: int) -> K2Plan:
    """Plan for `n` pixels whose maps start `label_offset` and
    `pred_offset` int32 elements past a 16-byte boundary, on a card with
    `sms` SMs, `smem_block` bytes of opt-in shared memory a block and
    `smem_sm` an SM: one C x C int32 histogram a block, two blocks an SM
    where two histograms fit, else one. Raises ValueError when one
    histogram does not fit a block."""
    smem = num_class * num_class * 4
    if num_class < 1 or smem > smem_block:
        raise ValueError(f'confusion_matrix_pallas: a {num_class}x'
                         f'{num_class} int32 histogram does not fit the '
                         f'{smem_block} bytes of shared memory of a block')
    blocks_per_sm = 2 if 2 * (smem + _SMEM_RESERVED) <= smem_sm else 1
    vec = label_offset % _VEC == pred_offset % _VEC
    head = min(n, -label_offset % _VEC) if vec else 0
    nvec = (n - head) // _VEC
    tail = n - head - _VEC * nvec
    grid = max(1, min(sms * blocks_per_sm,
                      -(-nvec // (_THREADS * _VECS))))
    chunk = -(-nvec // grid)
    chunk = -(-chunk // _CHUNK_ALIGN) * _CHUNK_ALIGN
    if chunk:
        grid = -(-nvec // chunk)
    return K2Plan(grid=grid, chunk=chunk, head=head, nvec=nvec, tail=tail,
                  vec=vec, smem=smem)


@lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int, int]:
    props = torch.cuda.get_device_properties(index)
    block = getattr(props, 'shared_memory_per_block_optin', 48 * 1024)
    sm = getattr(props, 'shared_memory_per_multiprocessor',
                 block + _SMEM_RESERVED)
    return props.multi_processor_count, block, sm


class _K2Args(ctypes.Structure):
    # K2Args in confusion_matrix.cu
    _fields_ = [('nvec', ctypes.c_int64), ('chunk', ctypes.c_int64),
                ('head', ctypes.c_int), ('tail', ctypes.c_int),
                ('vec', ctypes.c_int),
                ('blocks', ctypes.c_int), ('smem', ctypes.c_int)]


@lru_cache(maxsize=256)
def _args(plan: K2Plan):
    return ctypes.byref(_K2Args(
        nvec=plan.nvec, chunk=plan.chunk, head=plan.head, tail=plan.tail,
        vec=int(plan.vec), blocks=plan.grid, smem=plan.smem))


@lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load('confusion_matrix').rtseg_confusion_matrix
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _as_int32(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f'confusion_matrix_pallas: {what} must be int32 or '
                        f'int64, got {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'confusion_matrix_pallas: {what} must be '
                         f'contiguous')
    return t if t.dtype == torch.int32 else t.to(torch.int32)


def _offset(t: torch.Tensor, what: str) -> int:
    ptr = t.data_ptr()
    if ptr % 4:
        raise ValueError(f'confusion_matrix_pallas: {what} is not 4-byte '
                         f'aligned')
    return ptr // 4 % _VEC


def confusion_matrix_pallas(preds: torch.Tensor, labels: torch.Tensor,
                            num_class: int, ignore_index: int = 255
                            ) -> torch.Tensor:
    """(C, C) int32 confusion matrix, rows = true class, cols = predicted.
    Ignored pixels and labels or predictions outside [0, C) are dropped."""
    if preds.device.type == 'cpu' and labels.device.type == 'cpu':
        return confusion_matrix_plain(preds, labels, num_class, ignore_index)
    dev = preds.device
    if labels.device != dev or dev.type != 'cuda':
        raise ValueError(f'confusion_matrix_pallas: preds on {dev}, '
                         f'labels on {labels.device}; both must be on one '
                         f'CUDA device')
    n = preds.numel()
    if labels.numel() != n:
        raise ValueError(f'confusion_matrix_pallas: {n} predictions for '
                         f'{labels.numel()} labels')
    t = _as_int32(labels, 'labels')
    p = _as_int32(preds, 'preds')
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    plan = k2_plan(n, _offset(t, 'labels'), _offset(p, 'preds'), num_class,
                   *_device_limits(index))
    out = torch.empty((num_class, num_class), dtype=torch.int32,
                      device=dev)
    if n == 0:
        return out.zero_()
    with torch.cuda.device(index):
        rc = _entry()(t.data_ptr(), p.data_ptr(), out.data_ptr(), num_class,
                      ignore_index, _args(plan),
                      torch._C._cuda_getCurrentRawStream(index))
    cuda_build.check(rc, 'confusion_matrix')
    confusion_matrix_pallas.launches += 1
    return out


confusion_matrix_pallas.launches = 0
