"""Batched train and val iterators (counterpart of
rtseg_tpu/data/loader.py ShardedLoader, one process).

Train: a seeded permutation of the dataset each epoch,
np.random.default_rng((seed, epoch)).permutation(n) after set_epoch(epoch),
and the ragged tail dropped, as in the JAX loader. Val: dataset order,
every sample kept, a ragged last batch padded to the full batch by
repeating its last sample with labels set to ignore_index, so the
confusion matrix is unaffected and the eval step sees one shape. Batches
are torch tensors, NHWC float32 images and [B, H, W] int32 labels, in
pinned host memory when asked, so that the copy to the card can run
asynchronously; the samples of a batch are made on threads.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from .synthetic import Synthetic


class BatchLoader:
    # (scale, bias) of the uint8 raw tail's on-device normalize, or None:
    # the port's loader ships host-normalized float32 batches
    norm_coeffs = None

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = False, drop_last: bool = False,
                 ignore_index: int = 255, pin_memory: bool = False,
                 workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.ignore_index = ignore_index
        self.pin_memory = pin_memory
        # samples of a batch are made by this many threads (numpy releases
        # the GIL in the sample's heavy operations); 0 or 1 = serially
        self.workers = workers
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)
                                         ).permutation(n)
        return np.arange(n)

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
            im[slot], mm[slot] = self.dataset.get(int(idxs[slot]))
        list(map_fn(fill, range(len(idxs))))
        if len(idxs) < self.batch_size:         # ragged tail: pad + ignore
            im[len(idxs):] = im[len(idxs) - 1]
            mm[len(idxs):] = self.ignore_index
        return images, masks

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        order = self._epoch_indices()
        batches = [order[b * self.batch_size:(b + 1) * self.batch_size]
                   for b in range(len(self))]
        if self.workers <= 1:
            for idxs in batches:
                yield self._batch(idxs, map)
            return
        with ThreadPoolExecutor(self.workers) as pool:
            for idxs in batches:
                yield self._batch(idxs, pool.map)


def get_val_loader(config, pin_memory: bool = False) -> BatchLoader:
    """The val split of config.dataset. Only the synthetic dataset is
    ported: the Cityscapes reader needs an image decoder that the port's
    target machines lack (see ROADMAP.md)."""
    check_dataset(config)
    ds = Synthetic(config, mode='val')
    config.val_num = len(ds)
    return BatchLoader(ds, config.val_bs, ignore_index=config.ignore_index,
                       pin_memory=pin_memory, workers=config.base_workers)


def check_dataset(config) -> None:
    if config.dataset != 'synthetic':
        raise NotImplementedError(
            f'dataset {config.dataset!r} is not ported to PyTorch yet '
            f'(ported: synthetic); see ROADMAP.md')
