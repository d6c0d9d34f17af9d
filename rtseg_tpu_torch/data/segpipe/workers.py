"""Augment worker processes over a shared-memory ring (counterpart of
rtseg_tpu/data/segpipe/workers.py).

  * a ring of ``slots`` batch-sized buffers in one
    ``multiprocessing.shared_memory`` block: workers write augmented
    batches straight into a slot; the parent copies the batch out and
    recycles the slot;
  * tasks are (slot, epoch, batch index, sample indices); each worker
    draws from the per-sample generators of (seed, epoch, process, batch,
    slot in batch), so a batch is byte-identical to the serial path's
    whichever worker makes it;
  * a worker's exception is pickled back and raised in the parent; a
    worker that dies without reporting is found by polling its liveness
    and raises RuntimeError instead of hanging the loop.

Start method: ``forkserver``. The trainer makes a pool every epoch, by
when its process has initialised CUDA and runs threads (the async
checkpoint writer, the device prefetcher, the loader's producer); a fork
of that process would copy CUDA's state and whatever locks those threads
hold. The fork server is a fresh interpreter started without CUDA or
threads; it imports this module once (its preload) and forks each worker
from itself, so a worker starts in milliseconds and never touches CUDA.
What a worker receives (the sample source, the ring's name, the
parent's compile cache settings) is pickled; a worker of a parent with
the compile cache on loads the host library through the same cache.

The fork server and multiprocessing's resource tracker outlive every
pool, and on their own they exit only after the parent has gone: for a
moment the program leaves processes behind. :func:`shutdown` stops both
and waits for them; it is registered with ``atexit`` when the first pool
starts, and a caller may run it sooner.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import pickle
import queue as queue_mod
import traceback
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from ...warm.compile_cache import settings as cache_settings
from .source import SampleSource, assemble_batch, sample_rngs


_WORKER_PREFIX = 'segpipe-aug-'
_registered = False


def _context():
    global _registered
    if not _registered:
        # registered after multiprocessing's own exit hook, so it runs
        # before it: the helpers are gone when the interpreter ends
        atexit.register(shutdown)
        _registered = True
    ctx = mp.get_context('forkserver')
    ctx.set_forkserver_preload([__name__])
    return ctx


def shutdown() -> None:
    """Stop the processes the pools leave: any worker of a pool that was
    not closed, then the fork server, then the resource tracker, waiting
    for each to exit. A later pool starts them again."""
    import gc
    from multiprocessing import forkserver, resource_tracker
    for p in mp.active_children():
        if p.name.startswith(_WORKER_PREFIX):
            p.terminate()
            p.join(timeout=2.0)
    # the queues of closed pools unlink their semaphores when collected;
    # the tracker, once stopped, would unlink what is still registered
    gc.collect()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _slot_layout(want: int, img_shape, img_dtype, mask_shape, mask_dtype,
                 raw_tail: bool):
    img_dtype, mask_dtype = np.dtype(img_dtype), np.dtype(mask_dtype)
    img_b = want * int(np.prod(img_shape)) * img_dtype.itemsize
    mask_b = want * int(np.prod(mask_shape)) * mask_dtype.itemsize
    flag_b = want * 2 if raw_tail else 0
    return {
        'want': want,
        'img_shape': tuple(img_shape), 'img_dtype': img_dtype,
        'mask_shape': tuple(mask_shape), 'mask_dtype': mask_dtype,
        'raw_tail': raw_tail,
        'img_b': img_b, 'mask_b': mask_b, 'flag_b': flag_b,
        'slot_b': img_b + mask_b + flag_b,
    }


def _slot_views(buf, layout, slot: int):
    base = slot * layout['slot_b']
    want = layout['want']
    img = np.frombuffer(buf, layout['img_dtype'], offset=base,
                        count=want * int(np.prod(layout['img_shape']))
                        ).reshape((want,) + layout['img_shape'])
    mask = np.frombuffer(buf, layout['mask_dtype'],
                         offset=base + layout['img_b'],
                         count=want * int(np.prod(layout['mask_shape']))
                         ).reshape((want,) + layout['mask_shape'])
    flags = None
    if layout['raw_tail']:
        flags = np.frombuffer(buf, np.uint8,
                              offset=base + layout['img_b']
                              + layout['mask_b'],
                              count=want * 2).reshape(want, 2)
    return img, mask, flags


def _write_slot(buf, layout, slot: int, out) -> None:
    """Copy one batch into the ring slot; no view escapes (a live view
    would make SharedMemory.close raise BufferError)."""
    img_v, mask_v, flag_v = _slot_views(buf, layout, slot)
    img_v[:] = out[0]
    mask_v[:] = out[1]
    if flag_v is not None:
        flag_v[:] = out[2]


def _read_slot(buf, layout, slot: int):
    """Copy one batch out of the ring slot, which is recycled as soon as
    this returns; no view escapes."""
    img_v, mask_v, flag_v = _slot_views(buf, layout, slot)
    out = (np.array(img_v), np.array(mask_v))
    if flag_v is not None:
        out = out + (np.array(flag_v),)
    return out


def _worker_main(shm, layout, source: SampleSource, seed: int,
                 process_index: int, ignore_index: int, task_q, result_q,
                 compile_cache=None):
    if compile_cache is not None:
        # the parent's compile cache (warm/compile_cache.py settings()):
        # the host library loads from it here too
        from ...warm import enable_compile_cache
        enable_compile_cache(**compile_cache)
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            slot, epoch, b, idxs = task
            try:
                rngs = sample_rngs(seed, epoch, process_index, b,
                                   layout['want'])
                out = assemble_batch(source, idxs, rngs, layout['want'],
                                     ignore_index)
                _write_slot(shm.buf, layout, slot, out)
                result_q.put((b, slot, None, source.take_counts()))
            except Exception as e:      # report to the parent, keep serving
                try:
                    payload = pickle.dumps(e)
                except Exception:   # noqa: BLE001 (an unpicklable exception
                    # travels as its type, text and traceback)
                    payload = None
                result_q.put((b, slot,
                              (payload, type(e).__name__, str(e),
                               traceback.format_exc()), (0, 0)))
    finally:
        shm.close()                 # the parent unlinks the ring


class AugmentPool:
    """One epoch of multi-process batch production.

    ``run(batches)`` consumes (batch_index, local_idxs) pairs and yields
    the batches (images, masks[, flags]) **in batch order**, with up to
    ``slots`` batches in flight across ``workers`` processes. ``close()``
    (or leaving the ``with`` block) stops the processes and frees the ring
    even when the consumer stops early.
    """

    def __init__(self, source: SampleSource, want: int, img_shape,
                 img_dtype, mask_shape, mask_dtype, seed: int, epoch: int,
                 process_index: int, ignore_index: int, workers: int):
        from multiprocessing import shared_memory
        if workers < 1:
            raise ValueError(f'AugmentPool needs a worker, got {workers}')
        self.layout = _slot_layout(want, img_shape, img_dtype, mask_shape,
                                   mask_dtype, source.raw_tail)
        self.slots = workers + 2
        self.epoch = epoch
        self.hits = 0
        self.misses = 0
        ctx = _context()
        self._closed = True
        self._shm = shared_memory.SharedMemory(
            create=True, size=max(1, self.slots * self.layout['slot_b']))
        # run() submits a task only while a slot is free and each result
        # holds a slot, plus one stop sentinel a worker: the bound never
        # blocks, it only states the invariant
        self._task_q = ctx.Queue(maxsize=self.slots + workers)
        self._result_q = ctx.Queue(maxsize=self.slots + workers)
        #: teardown steps that raised (close() is best-effort)
        self.teardown_failures = 0
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(self._shm, self.layout, source, seed,
                              process_index, ignore_index, self._task_q,
                              self._result_q, cache_settings()),
                        daemon=True, name=f'{_WORKER_PREFIX}{w}')
            for w in range(workers)]
        self._closed = False
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------- epoch run
    def run(self, batches: Sequence[Tuple[int, np.ndarray]]
            ) -> Iterator[tuple]:
        todo = list(batches)
        free = list(range(self.slots))
        done: Dict[int, tuple] = {}
        order = [b for b, _ in todo]
        submit_at, yield_at = 0, 0
        while yield_at < len(order):
            while submit_at < len(todo) and free:
                b, idxs = todo[submit_at]
                self._task_q.put((free.pop(), self.epoch, b,
                                  np.asarray(idxs)))
                submit_at += 1
            if order[yield_at] in done:
                out = done.pop(order[yield_at])
                yield_at += 1
                yield out
                continue
            try:
                b, slot, err, counts = self._result_q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f'augment worker {dead[0].name} died '
                        f'(exitcode {dead[0].exitcode}) without reporting '
                        f'a result: batch production cannot continue')
                continue
            self.hits += counts[0]
            self.misses += counts[1]
            if err is not None:
                payload, typ, msg, tb = err
                exc = None
                if payload is not None:
                    try:
                        exc = pickle.loads(payload)
                    # an exception class whose __init__ takes other
                    # arguments fails to rebuild: report it as text
                    except Exception:   # noqa: BLE001
                        exc = None
                if exc is not None:
                    raise exc
                raise RuntimeError(
                    f'augment worker failed on batch {b}: {typ}: {msg}\n'
                    f'{tb}')
            done[b] = _read_slot(self._shm.buf, self.layout, slot)
            free.append(slot)

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            try:
                self._task_q.put_nowait(None)
            except queue_mod.Full:
                # the worker is terminated below instead
                self.teardown_failures += 1
        started = [p for p in self._procs if p.pid is not None]
        for p in started:
            p.join(timeout=2.0)
        for p in started:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        # drain the result queue so its feeder thread lets the process end
        try:
            while True:
                self._result_q.get_nowait()
        except (queue_mod.Empty, OSError, ValueError):
            pass
        for q in (self._task_q, self._result_q):
            q.close()
            q.join_thread()
        try:
            self._shm.close()
            self._shm.unlink()
        except FileNotFoundError:
            self.teardown_failures += 1

    def __enter__(self) -> 'AugmentPool':
        return self

    def __exit__(self, *exc) -> None:
        self.close()
