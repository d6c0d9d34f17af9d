"""SampleSource: cache-or-decode sample fetch and the shared batch
assembly (counterpart of rtseg_tpu/data/segpipe/source.py).

    base  = cache.read(i)            # packed-cache hit (mmap view)
          | dataset.prepare(i)       # miss: decode + deterministic resize
    final = dataset.augment(base, rng)        # host normalize tail, or
          | dataset.augment_raw(base, rng)    # uint8 + flip draws for the
                                              # card's stage

The serial loader, its thread pool and the augment worker processes all
call the same ``get``. The object pickles (the cache drops its mmaps), so
the worker processes receive it whole.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from .cache import PackedCache


def sample_rngs(seed: int, epoch: int, process_index: int, batch: int,
                n: int):
    """The per-sample augmentation rng: a fixed function of (seed, epoch,
    process, batch, slot), so neither thread scheduling nor worker
    assignment can change the draws. The one copy of the derivation, which
    the serial loader and the worker processes both call."""
    return [np.random.default_rng((seed, epoch, process_index, batch, j))
            for j in range(n)]


class SampleSource:
    def __init__(self, dataset, cache: Optional[PackedCache] = None,
                 raw_tail: bool = False):
        if raw_tail and not getattr(dataset, 'supports_raw_tail', False):
            raise ValueError(
                f'{type(dataset).__name__} does not support the raw uint8 '
                f'augment tail (float-native samples or color jitter on)')
        self.dataset = dataset
        self.cache = cache
        self.raw_tail = raw_tail
        # datasets outside the segpipe protocol (synthetic, tests) expose
        # only get(i, rng): serve them directly, uncached
        self._legacy = not hasattr(dataset, 'prepare')
        if cache is not None and self._legacy:
            raise ValueError(
                f'{type(dataset).__name__} has no prepare()/augment() '
                f'split; a packed cache cannot serve it')
        self.hits = 0
        self.misses = 0
        # the threaded fetch calls get() concurrently: `+= 1` needs a lock
        self._count_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.dataset)

    def __getstate__(self):
        d = dict(self.__dict__)
        d['_count_lock'] = None         # locks do not pickle
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._count_lock = threading.Lock()

    def _count(self, hit: bool) -> None:
        with self._count_lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def take_counts(self) -> Tuple[int, int]:
        """(hits, misses) since the last call; resets the counters."""
        with self._count_lock:
            h, m = self.hits, self.misses
            self.hits = self.misses = 0
        return h, m

    def get(self, index: int, rng: np.random.Generator):
        if self._legacy:
            self._count(hit=False)
            return self.dataset.get(index, rng)
        if self.cache is not None:
            image, mask = self.cache.read(index)
            self._count(hit=True)
        else:
            image, mask = self.dataset.prepare(index)
            self._count(hit=False)
        if self.raw_tail:
            return self.dataset.augment_raw(image, mask, rng)
        return self.dataset.augment(image, mask, rng)


def assemble_batch(source: SampleSource, idxs, rngs, want: int,
                   ignore_index: int, map_fn=None):
    """Stack ``want`` samples into one batch, padding a ragged tail by
    repeating the last sample with labels set to ignore_index. Returns
    (images, masks) or, for a raw-tail source, (images, masks, flags[B, 2]
    uint8) with the padded rows' flags those of the last sample.

    ``map_fn`` injects the fetch parallelism (a thread pool's ``map``);
    the default is serial. The draws come from ``rngs``, one generator a
    slot, so the map order cannot change them.
    """
    n_real = len(idxs)
    if not 0 < n_real <= want:
        raise ValueError(f'a batch of {want} takes 1 to {want} samples, '
                         f'got {n_real}')
    fetch = (lambda a: source.get(int(a[0]), a[1]))
    pairs = list(zip(idxs, rngs))
    samples = list(map_fn(fetch, pairs)) if map_fn is not None \
        else [fetch(p) for p in pairs]
    images = np.stack([s[0] for s in samples])
    masks = np.stack([s[1] for s in samples])
    flags = None
    if source.raw_tail:
        flags = np.array([s[2] for s in samples], np.uint8)
    if n_real < want:                       # ragged val tail: pad + ignore
        reps = want - n_real
        images = np.concatenate(
            [images, np.repeat(images[-1:], reps, axis=0)])
        pad_masks = np.full((reps,) + masks.shape[1:], ignore_index,
                            masks.dtype)
        masks = np.concatenate([masks, pad_masks])
        if flags is not None:
            # the padded rows repeat the last row's flip draws, so the
            # card's flip of them matches the host path's repeat of the
            # already-flipped last sample
            flags = np.concatenate(
                [flags, np.repeat(flags[-1:], reps, axis=0)])
    if flags is not None:
        return images, masks, flags
    return images, masks
