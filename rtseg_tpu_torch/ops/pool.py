"""The pools of the port's models (the counterpart of rtseg_tpu/ops/pool.py).

Public functions take NHWC tensors, like the JAX package; the `_nchw`
forms are what the model calls.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Size2 = Union[int, Tuple[int, int]]


def _pair(v: Size2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def max_pool_nchw(x: torch.Tensor, window: Size2,
                  stride: Optional[Size2] = None, padding: Size2 = 0
                  ) -> torch.Tensor:
    # F.max_pool2d pads with -inf, as lax.reduce_window does here
    return F.max_pool2d(x, _pair(window),
                        _pair(stride if stride is not None else window),
                        _pair(padding))


def avg_pool_nchw(x: torch.Tensor, window: Size2,
                  stride: Optional[Size2] = None, padding: Size2 = 0,
                  count_include_pad: bool = True) -> torch.Tensor:
    # summed in float32 and cast back, as the JAX package does. Pooled in
    # the contiguous NCHW layout and handed back in the input's: for a
    # channels_last input, avg_pool2d's backward on CUDA gave wrong input
    # gradients (PyTorch 2.11 on an H100; chip_smoke.py holds the card's
    # train steps to the CPU's)
    y = F.avg_pool2d(x.float().contiguous(), _pair(window),
                     _pair(stride if stride is not None else window),
                     _pair(padding), count_include_pad=count_include_pad)
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y.to(x.dtype)


def adaptive_avg_pool_nchw(x: torch.Tensor, output_size: Size2
                           ) -> torch.Tensor:
    # torch's adaptive windows are the JAX package's (_adaptive_windows copies
    # them): cell i covers [floor(i*in/out), ceil((i+1)*in/out)). Summed in
    # float32 and pooled in the contiguous NCHW layout, as avg_pool_nchw
    y = F.adaptive_avg_pool2d(x.float().contiguous(), _pair(output_size))
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y.to(x.dtype)


def _adaptive_windows(in_size: int, out_size: int):
    # torch's adaptive window math: cell i covers
    # [floor(i*in/out), ceil((i+1)*in/out))
    starts = [(i * in_size) // out_size for i in range(out_size)]
    ends = [-(-((i + 1) * in_size) // out_size) for i in range(out_size)]
    return starts, ends


def adaptive_max_pool_nchw(x: torch.Tensor, output_size: Size2
                           ) -> torch.Tensor:
    """Adaptive max pool as maxima over each cell (`amax`), as the JAX
    package takes them: at equal maxima the gradient is split evenly among
    them, where F.adaptive_max_pool2d sends it to one index."""
    oh, ow = _pair(output_size)
    n, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).amax(dim=(3, 5))
    hs, he = _adaptive_windows(h, oh)
    ws, we = _adaptive_windows(w, ow)
    rows = [torch.stack([x[:, :, hs[i]:he[i], ws[j]:we[j]].amax(dim=(2, 3))
                         for j in range(ow)], dim=-1) for i in range(oh)]
    return torch.stack(rows, dim=-2)


def global_avg_pool_nchw(x: torch.Tensor, keepdims: bool = True
                         ) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=keepdims)


def _nhwc(fn, x, *args, **kwargs):
    return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: Size2, stride: Optional[Size2] = None,
             padding: Size2 = 0) -> torch.Tensor:
    return _nhwc(max_pool_nchw, x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: Size2, stride: Optional[Size2] = None,
             padding: Size2 = 0, count_include_pad: bool = True
             ) -> torch.Tensor:
    return _nhwc(avg_pool_nchw, x, window, stride, padding,
                 count_include_pad)


def adaptive_avg_pool(x: torch.Tensor, output_size: Size2) -> torch.Tensor:
    return _nhwc(adaptive_avg_pool_nchw, x, output_size)


def adaptive_max_pool(x: torch.Tensor, output_size: Size2) -> torch.Tensor:
    return _nhwc(adaptive_max_pool_nchw, x, output_size)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return x.mean(dim=(1, 2), keepdim=keepdims)
