"""The batch loader (counterpart of rtseg_tpu/data/loader.py
ShardedLoader).

  * global batch = per-device batch x devices; each process makes only its
    contiguous slice of every batch (get_loader passes the process group's
    rank and size, parallel/mesh.py; an empty slice of a ragged val tail
    gets an all-ignored dummy batch, so every rank still runs the step);
  * the per-epoch reshuffle is np.random.default_rng((seed, epoch))
    .permutation(n), after set_epoch(epoch);
  * train batches drop the ragged tail; val batches pad it by repeating
    the last sample with labels set to ignore_index, so the confusion
    matrix is unaffected and the eval step sees one shape;
  * a sample comes through a segpipe SampleSource: a packed-cache read
    when a cache is attached (the decode otherwise), then the random
    augment suffix, host-normalized float32 or the raw uint8 tail whose
    flip and normalize run on the card (`[B, 2]` uint8 flip flags beside
    train batches, `emit_flags`);
  * batches are made by a producer thread, its samples on a thread pool
    (``workers``; numpy and the native library release the GIL) or in
    segpipe's worker processes over a shared-memory ring
    (``mp_workers``), both byte-identical to serial production;
  * with an event sink set (obs/core.py, the trainer's run()), each
    batch's production is a ``data/produce`` span and each epoch ends
    with one ``cache`` event (its ``tag``, the epoch, the packed cache's
    hits and misses), as in the JAX package.

Batches are tuples of CPU tensors (torch.from_numpy of the numpy batch):
NHWC float32 or uint8 images, [B, H, W] int32 labels and, on raw-tail
train batches, the flags.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..obs import get_sink, span
from .segpipe import AugmentPool, PackedCache, SampleSource, assemble_batch
from .segpipe.source import sample_rngs


class ShardedLoader:
    def __init__(self, dataset, global_batch: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 ignore_index: int = 255, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 2, workers: int = 0,
                 cache: Optional[PackedCache] = None,
                 raw_tail: bool = False, emit_flags: bool = True,
                 mp_workers: int = 0, tag: str = 'train'):
        if global_batch % process_count:
            raise ValueError(f'global batch {global_batch} does not split '
                             f'over {process_count} processes')
        self.dataset = dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.ignore_index = ignore_index
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # samples of a batch on this many threads; 0 or 1 = serially in the
        # producer. mp_workers > 0 takes worker processes instead
        self.workers = workers
        self.mp_workers = mp_workers
        self.tag = tag
        self.source = SampleSource(dataset, cache=cache, raw_tail=raw_tail)
        self.raw_tail = raw_tail
        self.emit_flags = emit_flags and raw_tail
        self.epoch = 0
        #: (hits, misses) of the packed cache over the last epoch
        self.last_cache_counts = (0, 0)
        # the all-ignored batch of an empty slice, made once an epoch
        self._dummy: Optional[tuple] = None
        self._dummy_epoch: Optional[int] = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return -(-n // self.global_batch)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def norm_coeffs(self):
        """(scale, bias) of the card's normalize stage, or None when the
        loader ships host-normalized float32."""
        if not self.raw_tail:
            return None
        return self.dataset.norm_coeffs()

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            return rng.permutation(n)
        return np.arange(n)

    def _strip(self, batch: tuple) -> tuple:
        """Drop the flag plane for consumers whose step takes none (val:
        the draws are always (False, False))."""
        if self.raw_tail and not self.emit_flags:
            batch = batch[:2]
        # a sample's own layout can reach np.stack (synthetic's masks come
        # out of a column gather in Fortran order)
        return tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in batch)

    def _dummy_batch(self, rng) -> tuple:
        """An empty slice of a ragged tail: an all-ignored batch, so every
        process still runs the step."""
        if self._dummy is not None and self._dummy_epoch == self.epoch:
            return self._dummy
        want = self.local_batch
        s0 = self.source.get(0, rng)
        img0, mask0 = s0[0], s0[1]
        images = np.repeat(np.asarray(img0)[None], want, axis=0)
        masks = np.full((want,) + mask0.shape, self.ignore_index,
                        mask0.dtype)
        batch = (images, masks)
        if self.raw_tail:
            batch = batch + (np.zeros((want, 2), np.uint8),)
        self._dummy = batch
        self._dummy_epoch = self.epoch
        return batch

    def _make_batch(self, idxs: np.ndarray, rngs, pool):
        if len(idxs) == 0:
            return self._dummy_batch(rngs[0])
        return assemble_batch(self.source, idxs, rngs, self.local_batch,
                              self.ignore_index,
                              map_fn=pool.map if pool is not None else None)

    def _sample_rngs(self, batch_idx: int):
        return sample_rngs(self.seed, self.epoch, self.process_index,
                           batch_idx, self.local_batch)

    def _local_slices(self, indices: np.ndarray):
        """[(batch_index, this process's index slice)] for the epoch."""
        out = []
        lo = self.process_index * self.local_batch
        for b in range(len(self)):
            batch_idx = indices[b * self.global_batch:
                                (b + 1) * self.global_batch]
            out.append((b, batch_idx[lo:lo + self.local_batch]))
        return out

    def _count_cache(self, extra_hits: int = 0, extra_misses: int = 0):
        h, m = self.source.take_counts()
        h, m = h + extra_hits, m + extra_misses
        self.last_cache_counts = (h, m)
        sink = get_sink()
        if sink is not None and (h or m):
            sink.emit({'event': 'cache', 'tag': self.tag,
                       'epoch': self.epoch, 'hits': h, 'misses': m,
                       'cached': self.source.cache is not None})

    # ------------------------------------------------------------- iteration
    def _iter_mp(self) -> Iterator[tuple]:
        """Augment worker processes over the shared-memory ring."""
        slices = self._local_slices(self._epoch_indices())
        work = [(b, idxs) for b, idxs in slices if len(idxs)]
        probe = self.source.get(0, self._sample_rngs(0)[0])
        # the probe's count is taken here: the workers receive the source,
        # and each would report it again
        probe_h, probe_m = self.source.take_counts()
        pool = AugmentPool(
            self.source, self.local_batch,
            probe[0].shape, probe[0].dtype, probe[1].shape, probe[1].dtype,
            seed=self.seed, epoch=self.epoch,
            process_index=self.process_index,
            ignore_index=self.ignore_index, workers=self.mp_workers)
        try:
            it = pool.run(work)
            for b, idxs in slices:
                with span('data/produce'):
                    batch = (self._dummy_batch(self._sample_rngs(b)[0])
                             if len(idxs) == 0 else next(it))
                yield self._strip(batch)
        finally:
            self._count_cache(probe_h + pool.hits, probe_m + pool.misses)
            pool.close()

    def _iter_threaded(self) -> Iterator[tuple]:
        """A producer thread (and a fetch thread pool)."""
        slices = self._local_slices(self._epoch_indices())
        pool = (ThreadPoolExecutor(max_workers=self.workers)
                if self.workers > 1 else None)
        stop = threading.Event()

        def put(q: queue.Queue, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(q: queue.Queue):
            try:
                for b, local_idx in slices:
                    # the producer's time a batch; the consumer's wait is
                    # the trainer's StepCollector's data wait
                    with span('data/produce'):
                        batch = self._make_batch(local_idx,
                                                 self._sample_rngs(b), pool)
                    if not put(q, self._strip(batch)):
                        return                  # the consumer went away
                put(q, None)
            except BaseException as e:          # raised in the consumer
                put(q, e)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=producer, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # unblock the producer if the consumer stops early
            stop.set()
            self._count_cache()
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        if self.mp_workers > 0:
            return self._iter_mp()
        return self._iter_threaded()
