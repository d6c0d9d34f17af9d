"""Batched validation iterator (the val side of rtseg_tpu/data/loader.py).

In dataset order, every sample kept: a ragged last batch is padded to the
full batch by repeating its last sample with labels set to ignore_index,
so the confusion matrix is unaffected and the eval step sees one shape,
as in the JAX loader. Batches are torch tensors, NHWC float32 images and
[B, H, W] int32 labels, in pinned host memory when asked, so that the
copy to the card can run asynchronously.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import torch

from .synthetic import Synthetic


class ValLoader:
    def __init__(self, dataset, batch_size: int, ignore_index: int = 255,
                 pin_memory: bool = False, workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.ignore_index = ignore_index
        self.pin_memory = pin_memory
        # samples of a batch are made by this many threads (numpy releases
        # the GIL in the sample's heavy operations); 0 or 1 = serially
        self.workers = workers

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _batch(self, idxs, map_fn) -> Tuple[torch.Tensor, torch.Tensor]:
        hw = (self.dataset.h, self.dataset.w)
        shape = (self.batch_size,)
        images = torch.empty(shape + hw + (3,), dtype=torch.float32,
                             pin_memory=self.pin_memory)
        masks = torch.empty(shape + hw, dtype=torch.int32,
                            pin_memory=self.pin_memory)
        im, mm = images.numpy(), masks.numpy()

        def fill(slot: int) -> None:
            # assignment writes C order whatever the sample's own order
            im[slot], mm[slot] = self.dataset.get(idxs[slot])
        list(map_fn(fill, range(len(idxs))))
        if len(idxs) < self.batch_size:         # ragged tail: pad + ignore
            im[len(idxs):] = im[len(idxs) - 1]
            mm[len(idxs):] = self.ignore_index
        return images, masks

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        n = len(self.dataset)
        starts = range(0, n, self.batch_size)
        if self.workers <= 1:
            for s in starts:
                yield self._batch(range(s, min(n, s + self.batch_size)), map)
            return
        with ThreadPoolExecutor(self.workers) as pool:
            for s in starts:
                yield self._batch(range(s, min(n, s + self.batch_size)),
                                  pool.map)


def get_val_loader(config, pin_memory: bool = False) -> ValLoader:
    """The val split of config.dataset. Only the synthetic dataset is
    ported: the Cityscapes reader needs an image decoder that the port's
    target machines lack (see ROADMAP.md)."""
    if config.dataset != 'synthetic':
        raise NotImplementedError(
            f'dataset {config.dataset!r} is not ported to PyTorch yet '
            f'(ported: synthetic); see ROADMAP.md')
    ds = Synthetic(config, mode='val')
    config.val_num = len(ds)
    return ValLoader(ds, config.val_bs, config.ignore_index, pin_memory,
                     workers=config.base_workers)
