"""Evaluation confusion matrix as a CUDA histogram kernel (K2).

Counterpart of rtseg_tpu/ops/pallas_metrics.py (the module keeps its name
so the two packages map path for path). The kernel is
ops/csrc/confusion_matrix.cu; its plain version is
`utils.metrics.confusion_matrix` (a bincount). The kernel counts with
integer atomics, so it is bit-equal to the plain version.

On CPU tensors `confusion_matrix_pallas` runs the plain version; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils.metrics import confusion_matrix as confusion_matrix_plain
from . import cuda_build

_THREADS = 256
_BLOCKS_PER_SM = 8


@lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load('confusion_matrix').rtseg_confusion_matrix
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
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
    return t.reshape(-1).to(torch.int32)


def confusion_matrix_pallas(preds: torch.Tensor, labels: torch.Tensor,
                            num_class: int, ignore_index: int = 255
                            ) -> torch.Tensor:
    """(C, C) int32 confusion matrix, rows = true class, cols = predicted.
    Ignored pixels and labels or predictions outside [0, C) are dropped."""
    if preds.device.type == 'cpu' and labels.device.type == 'cpu':
        return confusion_matrix_plain(preds, labels, num_class, ignore_index)
    if preds.device != labels.device or preds.device.type != 'cuda':
        raise ValueError(f'confusion_matrix_pallas: preds on {preds.device}, '
                         f'labels on {labels.device}; both must be on one '
                         f'CUDA device')
    if preds.numel() != labels.numel():
        raise ValueError(f'confusion_matrix_pallas: {preds.numel()} '
                         f'predictions for {labels.numel()} labels')
    props = torch.cuda.get_device_properties(preds.device)
    smem_limit = getattr(props, 'shared_memory_per_block_optin', 48 * 1024)
    if num_class < 1 or num_class * num_class * 4 > smem_limit:
        raise ValueError(f'confusion_matrix_pallas: a {num_class}x'
                         f'{num_class} int32 histogram does not fit the '
                         f'{smem_limit} bytes of shared memory of a block')
    t = _as_int32(labels, 'labels')
    p = _as_int32(preds, 'preds')
    n = t.numel()
    out = torch.zeros((num_class, num_class), dtype=torch.int32,
                      device=preds.device)
    if n == 0:
        return out
    blocks = max(1, min(-(-n // _THREADS),
                        props.multi_processor_count * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(preds.device).cuda_stream
    rc = _entry()(t.data_ptr(), p.data_ptr(), n, num_class, ignore_index,
                  out.data_ptr(), blocks, stream)
    cuda_build.check(rc, 'confusion_matrix')
    confusion_matrix_pallas.launches += 1
    return out


confusion_matrix_pallas.launches = 0
