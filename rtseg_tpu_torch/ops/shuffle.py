"""Channel reordering ops (the counterpart of rtseg_tpu/ops/shuffle.py).

`channel_shuffle` is ShuffleNet's group transpose, with the JAX package's
permutation: channel g*cpg + i goes to i*groups + g. LEDNet's SSnbt units
and Lite-HRNet's shuffle and CCW blocks end in it.

Public functions take NHWC tensors, like the JAX package; the `_nchw`
forms are what the models call. Those run the JAX construction on the NHWC
view of the channels_last NCHW tensor, so the shuffle is one copy and the
result stays channels_last.
"""

from __future__ import annotations

from typing import Tuple

import torch


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Transpose NHWC channels across `groups`: channel g*cpg + i ->
    i*groups + g."""
    n, h, w, c = x.shape
    if c % groups:
        raise ValueError(f'{c} channels do not split into {groups} groups')
    cpg = c // groups
    return x.reshape(n, h, w, groups, cpg).transpose(3, 4).reshape(n, h, w,
                                                                   c)


def channel_shuffle_nchw(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    return channel_shuffle(x.permute(0, 2, 3, 1), groups).permute(0, 3, 1, 2)


def channel_split(x: torch.Tensor, num: int = 2) -> Tuple[torch.Tensor, ...]:
    """Even split of NHWC channels into `num` parts (jnp.split: the
    channels must divide evenly)."""
    c = x.shape[-1]
    if c % num:
        raise ValueError(f'{c} channels do not split evenly into {num}')
    return torch.split(x, c // num, dim=-1)

