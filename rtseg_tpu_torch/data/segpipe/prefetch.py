"""Device prefetch (counterpart of rtseg_tpu/data/segpipe/prefetch.py).

``DevicePrefetcher`` runs ``put_fn(batch) for batch in it`` on a
background thread with ``depth`` results in flight: while the card runs
step N, the thread already copies batch N+1 (and the loader's producer
assembles N+2). Order is kept (one producer thread, a FIFO queue), an
exception of the loader or of the copy is raised in the consumer, and
``close()`` stops the thread without a deadlock when the consumer stops
early.

``CardCopier`` is the ``put_fn`` for a CUDA device. Each host batch is
copied into a ring of pinned host buffers and from there to the card on
a side stream, with three rules, since a race here gives wrong pixels,
not an error:
  * a pinned buffer is refilled only after the event of its last copy to
    the card has completed;
  * the card tensors are allocated on the side stream and
    ``record_stream``ed on the consuming stream, so the caching allocator
    does not hand their memory to the side stream again before the
    consumer's work on them is done;
  * ``ready(item)``, called by the consumer, makes the consuming stream
    wait on the copy's event before it returns the tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import torch


class DevicePrefetcher:
    """Iterate ``put_fn(batch) for batch in it`` with ``depth`` transfers
    in flight on a background thread."""

    def __init__(self, it: Iterable, put_fn: Callable[[Any], Any],
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f'prefetch depth must be at least 1, got {depth}')
        self._src = it
        self._put_fn = put_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        #: producer-side best-effort steps that raised (closing the
        #: source, handing an error over)
        self.producer_failures = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='segpipe-h2d')
        self._thread.start()

    # ------------------------------------------------------- producer thread
    def _offer(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        it = None
        try:
            # inside the try: a source whose __iter__ raises reaches the
            # consumer as that exception, not as an empty epoch
            it = iter(self._src)
            while not self._stop.is_set():
                try:
                    batch = next(it)
                except StopIteration:
                    self._offer(None)
                    return
                if not self._offer(self._put_fn(batch)):
                    return              # the consumer went away
        except BaseException as e:      # loader or copy errors -> consumer
            if not self._offer(e):
                self.producer_failures += 1
        finally:
            # the generator belongs to this thread: closing it here runs
            # the loader's own teardown (its producer thread, its pool)
            close = getattr(it, 'close', None)
            if close is not None:
                try:
                    close()
                except Exception:   # noqa: BLE001 (counted, not silent)
                    self.producer_failures += 1

    # --------------------------------------------------------- consumer side
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # the thread offers None or an exception before it
                    # ends unless it was killed: do not wait for it
                    raise StopIteration
        if item is None:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self) -> None:
        """Stop the producer and release the source; safe to call more
        than once."""
        self._stop.set()
        try:                            # unblock a producer on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> 'DevicePrefetcher':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CardCopier:
    """Copies host batches (tuples of CPU tensors) to a CUDA device through
    ``slots`` pinned buffers a tensor and a side stream. ``__call__`` runs
    on the prefetch thread and returns an item for ``ready``, which the
    consumer calls on the stream that will use the tensors."""

    def __init__(self, device: torch.device, slots: int = 3):
        if slots < 1:
            raise ValueError(f'CardCopier needs a slot, got {slots}')
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        # the stream of the thread that builds the copier consumes
        self.consumer = torch.cuda.current_stream(self.device)
        self._slots = slots
        self._ring: List[Optional[tuple]] = [None] * slots
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def _pinned(self, slot: int, batch) -> tuple:
        bufs = self._ring[slot]
        if bufs is None or any(b.shape != t.shape or b.dtype != t.dtype
                               for b, t in zip(bufs, batch)) \
                or len(bufs) != len(batch):
            bufs = tuple(torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True) for t in batch)
            self._ring[slot] = bufs
        return bufs

    def __call__(self, batch) -> tuple:
        slot = self._next
        self._next = (slot + 1) % self._slots
        if self._events[slot] is not None:
            # the card may still be reading this slot's pinned buffers
            self._events[slot].synchronize()
        bufs = self._pinned(slot, batch)
        for buf, t in zip(bufs, batch):
            buf.copy_(t)
        with torch.cuda.stream(self.stream):
            out = []
            for buf in bufs:
                dev = torch.empty(buf.shape, dtype=buf.dtype,
                                  device=self.device)
                dev.copy_(buf, non_blocking=True)
                dev.record_stream(self.consumer)
                out.append(dev)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[slot] = event
        return tuple(out), event

    def ready(self, item) -> tuple:
        """The card tensors of one __call__, once the consuming stream has
        been made to wait for their copy."""
        tensors, event = item
        self.consumer.wait_event(event)
        return tensors
