"""Process groups for data-parallel training (counterpart of
rtseg_tpu/parallel/mesh.py).

The JAX package trains over one `('data',)` mesh of every chip, its step
under `shard_map` with the batch split over the axis and `lax.pmean` /
`psum` for the gradients, the BatchNorm statistics and the confusion
matrix. The port runs one process a card over torch.distributed: N ranks
of a local batch b compute what the JAX package's mesh of N devices
computes with a global batch N*b.

  * `init_multihost(config, device)` opens the process group: under
    config.multihost at tcp://coordinator_address with process_id and
    num_processes (a missing field raises ValueError; the fields set
    without multihost raise too); else, where a launcher's environment
    names a world (torchrun or `python -m torch.distributed.run`: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), at env://; else it opens none.
    A group the caller opened already is used as it is. The backend is
    NCCL for a CUDA device and gloo for the CPU, chosen by the device the
    caller resolved; one is never swapped for the other, and an NCCL
    failure propagates. A caller that wants gloo on a card (two ranks
    sharing one card, which NCCL refuses) opens that group itself.
  * `process_count()`, `process_index()`, `main_rank()`: 1, 0 and True
    without a group.
  * `local_device(name)`: cuda:LOCAL_RANK (0 without a launcher) for None
    or 'cuda', a named index as named, the CPU only when named. One
    process drives one card under --multihost too (the JAX package runs
    one process a host): on a host with several cards each process names
    its card (main_torch.py `--device cuda:K`) or has LOCAL_RANK set.
  * `all_reduce_sum` / `all_reduce_mean` of one tensor (a reduced copy),
    `average_` of many in place through one flat buffer (the train step's
    gradients), `barrier()`; without a group they issue no collective.
  * `AllReduceSum`: an all-reduce that autograd differentiates, SUM
    forward and SUM backward (the transpose JAX takes for `lax.pmean`
    under shard_map, so statistics averaged through it give every rank
    the global batch's gradient); `all_reduce_mean_grad` divides it by the
    world size. The synced BatchNorm (nn/modules.py) averages its
    statistics through it.

`make_mesh`, `batch_sharding`, `make_global_array` and the rest of the
GSPMD placement have no counterpart: one process drives one card, and
each process's loader makes only its slice of the global batch
(data/loader.py). The `('data', 'spatial')` mesh is not ported (ROADMAP.md
Queue 1, "Spatial mesh"), nor is one process driving several cards
(`nn.DataParallel`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER = ('RANK', 'WORLD_SIZE')
_COORDINATOR = ('coordinator_address', 'process_id', 'num_processes')


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def main_rank() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    """The open group's backend ('nccl', 'gloo'), or None."""
    return dist.get_backend() if is_distributed() else None


def _launcher_env() -> bool:
    """Whether a launcher's environment names a world (RANK and
    WORLD_SIZE set, as torchrun sets them)."""
    return all(k in os.environ for k in _LAUNCHER)


def local_device(name=None) -> torch.device:
    """This process's device: cuda:LOCAL_RANK for None or 'cuda' (LOCAL_RANK
    0 where no launcher set it), a CUDA index or the CPU as named."""
    device = torch.device('cuda' if name is None else name)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return device


def init_multihost(config, device) -> bool:
    """Open the process group config and the environment ask for, with
    the backend of `device`; True where this call opened one."""
    device = torch.device(device)
    if config.multihost:
        missing = [f for f in _COORDINATOR if getattr(config, f) is None]
        if missing:
            raise ValueError(f'multihost=True needs {", ".join(missing)} '
                             f'(the coordinator host:port, this process\'s '
                             f'id and the number of processes)')
        init_method = f'tcp://{config.coordinator_address}'
        rank, world = int(config.process_id), int(config.num_processes)
    else:
        given = [f for f in _COORDINATOR if getattr(config, f) is not None]
        if given:
            raise ValueError(f'{", ".join(given)} set without multihost=True '
                             f'(--multihost): set multihost or leave them '
                             f'unset')
        if not _launcher_env():
            return False
        init_method, rank, world = 'env://', None, None
    if is_distributed():
        if world is not None and dist.get_world_size() != world:
            raise ValueError(f'an open process group of '
                             f'{dist.get_world_size()} ranks, but '
                             f'num_processes={world}')
        return False
    kind = 'nccl' if device.type == 'cuda' else 'gloo'
    if kind == 'nccl':
        torch.cuda.set_device(device)
    if rank is None:
        dist.init_process_group(kind, init_method=init_method)
    else:
        dist.init_process_group(kind, init_method=init_method, rank=rank,
                                world_size=world)
    return True


def close() -> None:
    """Close the process group, where one is open."""
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if not is_distributed():
        return
    if backend() == 'nccl':
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor); `t` itself without a
    group."""
    if not is_distributed():
        return t
    out = t.clone()
    dist.all_reduce(out)
    return out


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of a floating `t` over the ranks: their sum divided by the
    world size (a new tensor); `t` itself without a group."""
    if not is_distributed():
        return t
    return all_reduce_sum(t).div_(dist.get_world_size())


def average_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each of `tensors` (one floating type) by its mean over the
    ranks: one all-reduce (SUM) of one flat buffer, divided by the world
    size. Nothing without a group."""
    if not is_distributed() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors),
                         [p.view_as(t) for p, t in zip(parts, tensors)])


class AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) in the forward and in the backward."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def all_reduce_mean_grad(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks of the open group, differentiable
    (`AllReduceSum` divided by the world size)."""
    return AllReduceSum.apply(t) / dist.get_world_size()
