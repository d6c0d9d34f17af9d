"""Train state (counterpart of rtseg_tpu/train/state.py).

Where the JAX package carries one functional pytree, the port holds the
objects PyTorch updates in place: the model (parameters and BatchNorm
running statistics), its SGD optimizer (momentum buffers), the EMA copy of
the model, and the count of updates taken. The EMA covers the parameters
and the running statistics, the whole state_dict of the reference's
ModelEmaV2 except BatchNorm's `num_batches_tracked` counter, which the JAX
package does not have.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

_TORCH_ONLY = 'num_batches_tracked'


@dataclass
class TrainState:
    step: int                          # updates taken, == reference train_itrs
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_model: torch.nn.Module         # kept in eval()


def ema_tensors(model: torch.nn.Module) -> List[torch.Tensor]:
    """The tensors the EMA tracks, in state_dict order."""
    return [t for k, t in model.state_dict().items()
            if not k.endswith(_TORCH_ONLY)]


def make_ema_model(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` for the EMA, built once and kept in eval()."""
    ema = copy.deepcopy(model).eval()
    for p in ema.parameters():
        p.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(new: torch.nn.Module, ema: torch.nn.Module,
               decay: float) -> None:
    """Reference ramp EMA, in float32: ema = decay * ema + (1 - decay) * new
    (two products, then their sum)."""
    decay = np.float32(decay)
    e, m = ema_tensors(ema), ema_tensors(new)
    part = torch._foreach_mul(m, float(np.float32(1.0) - decay))
    torch._foreach_mul_(e, float(decay))
    torch._foreach_add_(e, part)


@torch.no_grad()
def ema_mirror(new: torch.nn.Module, ema: torch.nn.Module) -> None:
    """use_ema=False: the EMA is an exact copy of the model."""
    torch._foreach_copy_(ema_tensors(ema), ema_tensors(new))
