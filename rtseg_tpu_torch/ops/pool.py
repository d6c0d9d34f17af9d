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


# ------------------------------------------------------ argmax pool / unpool

def max_pool_argmax_2x2(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 max pool of NHWC `x`: (values, the within-window
    position of the maximum in [0, 4) as int8), odd trailing rows and
    columns truncated. The JAX package's construction, not
    F.max_pool2d(return_indices=True): the values are the nested maximum
    of the four strided slices, so at equal values the gradient is split
    as jax.grad splits it (evenly between the two sides of each
    `maximum`; 0.25 each on a four-way tie), where F.max_pool2d sends it
    all to one position; the index takes the first maximum in row-major
    order; and the index maps are int8, an eighth of torch's int64 ones."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    x = x[:, :h2 * 2, :w2 * 2, :]
    a = x[:, 0::2, 0::2, :]
    b = x[:, 0::2, 1::2, :]
    c = x[:, 1::2, 0::2, :]
    d = x[:, 1::2, 1::2, :]
    vals = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    code = torch.full((), 3, dtype=torch.int8, device=x.device)
    for k, s in ((2, c), (1, b), (0, a)):
        code = torch.where(s >= vals, k, code)
    return vals, code


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor,
                   out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The inverse of max_pool_argmax_2x2 on NHWC `x`: each value goes to
    its position `idx` of a 2x2 window, the others are 0. Four `where`
    planes interleaved by stacking on new adjacent axes (no scatter), then
    zero-padded at the bottom and right to `out_hw`."""
    n, h2, w2, c = x.shape
    planes = [torch.where(idx == k, x, 0.0) for k in range(4)]
    top = torch.stack(planes[0:2], dim=3).reshape(n, h2, 2 * w2, c)
    bot = torch.stack(planes[2:4], dim=3).reshape(n, h2, 2 * w2, c)
    out = torch.stack([top, bot], dim=2).reshape(n, 2 * h2, 2 * w2, c)
    if out_hw is not None and tuple(out_hw) != (h2 * 2, w2 * 2):
        oh, ow = out_hw
        out = F.pad(out, (0, 0, 0, ow - w2 * 2, 0, oh - h2 * 2))
    return out


def max_pool_argmax_2x2_nchw(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """max_pool_argmax_2x2 on the NHWC view of NCHW `x`: channels_last
    values and index maps for a channels_last input."""
    vals, idx = max_pool_argmax_2x2(x.permute(0, 2, 3, 1))
    return vals.permute(0, 3, 1, 2), idx.permute(0, 3, 1, 2)


def max_unpool_2x2_nchw(x: torch.Tensor, idx: torch.Tensor,
                        out_hw: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    return max_unpool_2x2(x.permute(0, 2, 3, 1), idx.permute(0, 2, 3, 1),
                          out_hw).permute(0, 3, 1, 2)


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
