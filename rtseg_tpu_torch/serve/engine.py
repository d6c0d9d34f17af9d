"""ServeEngine: shape-bucketed inference with one CUDA graph a bucket
(counterpart of rtseg_tpu/serve/engine.py).

The JAX engine compiles one AOT executable a configured (H, W) bucket, all
at one fixed batch, and arms a recompile guard over that sealed table. The
port captures one CUDA graph a bucket at construction instead: the
inference function (export.build_inference_fn: the model in eval mode,
its own full-resolution upsample, an int8 channel argmax) is run twice on
the engine's stream to warm up, then captured once into a graph over a
static input buffer; every later batch of that bucket is copied into the
static input and the graph is replayed. The table is sealed: a bucket
that was not captured raises UnknownBucket, and a capture after
construction counts in ``stats()['retraces']`` and raises SealedTable. A
model whose eval forward cannot be captured (a host sync, a dynamic
shape) fails the construction; the engine never falls back to eager
execution on the card. On a CPU device that the caller names, the same
function runs eagerly.

An engine comes from a config (``from_config``: the model, its weights
from a checkpoint of the port or Flax's initializers) or from a
`torch.export` artifact (``from_artifact``, export.py: the program alone,
no model code; its input spec fixes the one bucket). Either function is
captured the same way.

The executable cache (``exe_cache``, ``pins``; warm/): what the port
compiles are its kernel libraries (warm/exe_cache.py), and the engine's
graphs launch none of them (serving never defers the upsample to K1), so
an engine acquires no library through its cache, ``stats()['cache_hits']``
counts none, and the graphs are captured at every start: a captured CUDA
graph cannot be stored and loaded in another process. The pins are
checked as the JAX engine's (warm/prime.py make_pins). The libraries of
the serving path (the host library that decodes request bodies) go
through the process's compile cache, which the serve CLI and
``from_config`` with ``config.compile_cache`` turn on. The
JAX engine compiles its buckets on ``compile_workers`` threads; a capture
needs the engine's one stream and graph pool, so the port captures them
one after another and refuses ``compile_workers`` above 0.

A graph writes the same static output on every replay, so a second
replay of a bucket overwrites the first one's mask while that batch may
still be in flight to its reader (the pipeline keeps two batches in
flight). Each replay is therefore followed, on the engine's stream, by a
copy of its int8 output into a pinned host slot of a ring (SLOTS = 3 a
bucket: the pipeline's two batches in flight and one more) and an
event; the handle that
``dispatch`` returns waits on that event alone (never on the whole
device), copies the slot out and frees it. ``dispatch`` blocks while
every slot of the bucket is held by a handle not yet read. The static
input is refilled by an asynchronous copy from one of two pinned staging
buffers, enqueued on the same stream, so it lands after the previous
replay; a staging buffer is rewritten only after its last copy finished.

Batch-dim padding is exact (the JAX engine's contract): an eval forward
has no cross-sample operation, and a graph replays the same kernels for a
full batch and a padded one, so a request's mask does not depend on how
full its batch was. Spatial padding is not exact for models with global
context; prediction therefore buckets by exact image shape.
"""

from __future__ import annotations

import queue
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import not_ported
from ..obs import span

Bucket = Tuple[int, int]

#: eager runs on the engine's stream before a bucket's capture
WARMUP = 2
#: pinned output slots a bucket: the pipeline's two batches in flight,
#: and one more for the batch the reader is copying out
SLOTS = 3


class UnknownBucket(ValueError):
    """No configured bucket fits the request's (h, w)."""


class SealedTable(RuntimeError):
    """A CUDA graph capture was asked for after the engine's construction."""


def parse_buckets(spec: str) -> List[Bucket]:
    """'512x1024,256x512' -> [(512, 1024), (256, 512)]."""
    out: List[Bucket] = []
    for part in spec.split(','):
        part = part.strip()
        if not part:
            continue
        h, _, w = part.partition('x')
        out.append((int(h), int(w)))
    if not out:
        raise ValueError(f'no buckets in spec {spec!r}')
    return out


def select_bucket(buckets: Sequence[Bucket], h: int, w: int
                  ) -> Optional[Bucket]:
    """Smallest-area bucket that fits (h, w); None when nothing fits."""
    fits = [(bh * bw, bh, bw) for bh, bw in buckets if bh >= h and bw >= w]
    if not fits:
        return None
    _, bh, bw = min(fits)
    return (bh, bw)


def assemble_batch(images: Sequence[np.ndarray], bucket: Bucket, batch: int
                   ) -> np.ndarray:
    """Stack ``images`` (each (h, w, 3) f32, h<=H, w<=W) into one
    (batch, H, W, 3) array: zero-pad each image to the bucket spatially,
    zero-fill the unused batch rows."""
    if len(images) > batch:
        raise ValueError(f'{len(images)} requests > bucket batch {batch}')
    bh, bw = bucket
    out = np.zeros((batch, bh, bw, 3), np.float32)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        if h > bh or w > bw:
            raise UnknownBucket(f'image {h}x{w} exceeds bucket {bh}x{bw}')
        out[i, :h, :w] = img
    return out


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; the CPU only when the caller names it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("ServeEngine: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return device


@contextmanager
def _fixed_cudnn():
    """cuDNN's heuristic algorithm choice (benchmark off) for the warm-up
    and the capture, so a replay runs the kernels an eager call picks."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


class _Slot:
    """A pinned host buffer and the event of the last copy through it."""

    def __init__(self, shape, dtype):
        self.tensor = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.array = self.tensor.numpy()
        self.done = torch.cuda.Event(blocking=True)


class _Graph:
    """One bucket's captured graph, its static buffers and host slots."""

    def __init__(self, graph, static_in, static_out, inputs, outputs):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.inputs = inputs
        self.outputs = outputs
        self.next_input = 0
        self.free: queue.Queue = queue.Queue()
        for i in range(len(outputs)):
            self.free.put(i)


class Pending:
    """A dispatched batch. ``result()`` returns its (batch, H, W) int8
    masks as a fresh array: on the card it waits for the batch's copy
    into its pinned slot (that event alone), copies the slot out and frees
    it for the next dispatch. Read every handle: an unread one holds its
    slot."""

    def __init__(self, value: Optional[np.ndarray] = None,
                 slot: Optional[_Slot] = None,
                 release: Optional[Callable[[], None]] = None):
        self._value = value
        self._slot = slot
        self._release = release

    def result(self) -> np.ndarray:
        if self._value is None:
            try:
                self._slot.done.synchronize()
                self._value = self._slot.array.copy()
            finally:
                slot, self._slot = self._slot, None
                if slot is not None:
                    self._release()
        return self._value


class ServeEngine:
    """A sealed table of inference programs, one a bucket: a CUDA graph on
    the card, the eager function on the CPU.

    ``fn(images: f32[B, H, W, 3]) -> int8[B, H, W]`` runs at the engine's
    fixed ``batch``. ``dispatch`` only looks the bucket's graph up and
    replays it; ``run`` is dispatch + readback.
    """

    def __init__(self, fn: Callable, buckets: Sequence[Bucket], batch: int,
                 device=None, name: str = 'serve_engine',
                 exe_cache=None, pins=None, compile_workers: int = 0):
        # exe_cache and pins are the JAX engine's: the pins are checked,
        # and nothing is acquired through the cache (module docstring)
        if compile_workers:
            raise not_ported(f'compile_workers={compile_workers} (parallel '
                             f'bucket builds; the port captures its graphs '
                             f'one after another)', 'The planes')
        if pins is not None:
            from ..warm import make_pins
            make_pins(**pins)
        if not buckets:
            raise ValueError('ServeEngine needs at least one bucket')
        if batch < 1:
            raise ValueError(f'batch must be >= 1, got {batch}')
        self.device = resolve_device(device)
        self.buckets: List[Bucket] = sorted({(int(h), int(w))
                                             for h, w in buckets})
        self.batch = int(batch)
        self.name = name
        self.fn = fn
        self._table: Dict[Bucket, Optional[_Graph]] = {}
        self._calls = {b: 0 for b in self.buckets}
        self._images = 0
        self._retraces = 0        # captures asked for after construction
        self._sealed = False
        self._lock = threading.Lock()
        self.stream = None
        self.pool = None
        if self.device.type == 'cuda':
            self.stream = torch.cuda.Stream(self.device)
            # one memory pool for every bucket's graph
            self.pool = torch.cuda.graph_pool_handle()
        for b in self.buckets:
            self.capture(b)
        self._sealed = True

    # -------------------------------------------------------------- capture
    def capture(self, bucket: Bucket) -> None:
        """Add ``bucket`` to the table: its graph on the card. Only the
        constructor may: afterwards it counts a retrace and raises."""
        bucket = (int(bucket[0]), int(bucket[1]))
        if self._sealed:
            self._retraces += 1
            raise SealedTable(f'{self.name}: capture of bucket {bucket[0]}x'
                              f'{bucket[1]} after construction; the table '
                              f'is sealed')
        if self.device.type != 'cuda':
            self._table[bucket] = None
            return
        bh, bw = bucket
        with span('serve/capture', bucket=f'{bh}x{bw}', batch=self.batch), \
                torch.cuda.device(self.device), _fixed_cudnn(), \
                torch.no_grad():
            static_in = torch.zeros((self.batch, bh, bw, 3),
                                    dtype=torch.float32, device=self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                for _ in range(WARMUP):
                    self.fn(static_in)
            self.stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode='thread_local'):
                static_out = self.fn(static_in)
        if static_out.shape != (self.batch, bh, bw) \
                or static_out.dtype != torch.int8:
            raise ValueError(f'{self.name}: fn gave {tuple(static_out.shape)}'
                             f' {static_out.dtype} for bucket {bh}x{bw}, not '
                             f'({self.batch}, {bh}, {bw}) int8')
        inputs = [_Slot((self.batch, bh, bw, 3), torch.float32)
                  for _ in range(2)]
        outputs = [_Slot((self.batch, bh, bw), torch.int8)
                   for _ in range(SLOTS)]
        self._table[bucket] = _Graph(graph, static_in, static_out, inputs,
                                     outputs)

    def graph(self, bucket: Bucket) -> Optional[_Graph]:
        """The bucket's graph entry (None on the CPU)."""
        return self._table[tuple(bucket)]

    # -------------------------------------------------------------- running
    def select(self, h: int, w: int) -> Bucket:
        b = select_bucket(self.buckets, h, w)
        if b is None:
            raise UnknownBucket(
                f'no bucket fits {h}x{w}; configured: '
                + ','.join(f'{bh}x{bw}' for bh, bw in self.buckets))
        return b

    def dispatch(self, bucket: Bucket, images: np.ndarray) -> Pending:
        """Run one padded batch (exactly the bucket's (batch, H, W, 3)
        f32 shape) asynchronously; returns its handle."""
        bucket = (int(bucket[0]), int(bucket[1]))
        if bucket not in self._table:
            raise UnknownBucket(f'bucket {bucket} was not captured')
        want = (self.batch, bucket[0], bucket[1], 3)
        if tuple(images.shape) != want:
            raise ValueError(f'batch {tuple(images.shape)} is not the '
                             f'bucket\'s {want}')
        entry = self._table[bucket]
        with self._lock:                      # one dispatch at a time
            if entry is None:
                x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
                handle = Pending(value=self.fn(x.to(self.device)).numpy())
            else:
                k = entry.free.get()          # a slot no handle holds
                staging = entry.inputs[entry.next_input]
                entry.next_input = 1 - entry.next_input
                staging.done.synchronize()    # its last copy has landed
                np.copyto(staging.array, images)
                out = entry.outputs[k]
                with torch.cuda.stream(self.stream):
                    entry.static_in.copy_(staging.tensor, non_blocking=True)
                    staging.done.record(self.stream)
                    entry.graph.replay()
                    out.tensor.copy_(entry.static_out, non_blocking=True)
                    out.done.record(self.stream)
                handle = Pending(slot=out, release=lambda: entry.free.put(k))
            self._calls[bucket] += 1
            self._images += self.batch
        return handle

    def run(self, bucket: Bucket, images: np.ndarray) -> np.ndarray:
        """Synchronous ``dispatch`` + host readback."""
        return self.dispatch(bucket, images).result()

    def stats(self) -> dict:
        """The JAX engine's keys: ``executables`` counts the table's
        entries (a CUDA graph each on the card), ``cache_hits`` the
        libraries the engine acquired from its cache (none: module
        docstring); ``cuda_graphs`` is the port's own."""
        return {
            'buckets': [f'{h}x{w}' for h, w in self.buckets],
            'batch': self.batch,
            'executables': len(self._table),
            'cuda_graphs': sum(e is not None for e in self._table.values()),
            'calls': {f'{h}x{w}': n for (h, w), n in self._calls.items()},
            'images': self._images,
            'retraces': self._retraces,
            'cache_hits': 0,
        }

    # -------------------------------------------------------- constructors
    @classmethod
    def from_config(cls, config, buckets: Sequence[Bucket], batch: int,
                    ckpt_path: Optional[str] = None, variables=None,
                    name: str = 'serve_engine',
                    device=None) -> 'ServeEngine':
        """Engine of the configured model on ``device`` (the card unless
        the CPU is named). Weights: ``variables`` (a Flax-shaped tree,
        utils/convert.py), else a checkpoint of the port at ``ckpt_path``
        over Flax's initializers, else Flax's initializers alone drawn
        from seed 0 (load generation only; not the JAX engine's
        PRNGKey(0) values). With ``config.compile_cache`` the process's
        compile cache is turned on under ``config.compile_cache_dir``
        (the libraries this process builds from now on go through it)
        and the engine gets it and the JAX engine's pins;
        ``config.compile_workers`` as the constructor's."""
        from ..export import build_inference_fn
        from ..models.registry import get_model
        from ..train.checkpoint import restore_weights
        from ..utils.convert import flax_init_variables, load_jax_variables

        device = resolve_device(device)
        model = get_model(config, device=device).eval()
        if variables is None:
            load_jax_variables(model, flax_init_variables(model, 0))
            if ckpt_path:
                restore_weights(ckpt_path, model)
        else:
            load_jax_variables(model, variables)
        fn = build_inference_fn(model, config.compute_dtype, argmax=True)
        exe_cache = pins = None
        if getattr(config, 'compile_cache', False):
            from ..warm import enable_compile_cache, make_pins
            from ..warm.compile_cache import active_cache
            enable_compile_cache(config)
            exe_cache = active_cache()
            pins = make_pins(bn_axis=None,
                             s2d_stem=bool(getattr(config, 's2d_stem',
                                                   False)),
                             defer_upsample=False)
        return cls(fn, buckets, batch, device=device, name=name,
                   exe_cache=exe_cache, pins=pins,
                   compile_workers=getattr(config, 'compile_workers', 0))

    @classmethod
    def from_artifact(cls, path: str, batch: Optional[int] = None,
                      name: str = 'serve_engine', device=None,
                      exe_cache=None) -> 'ServeEngine':
        """Engine from a `torch.export` artifact (export.py, `.pt2`),
        loaded onto ``device`` (the card unless the CPU is named) and
        captured as one CUDA graph there, eager on the CPU. The artifact's
        input spec fixes the one bucket; a symbolic batch dimension takes
        ``batch`` from the caller, a static one must match it.
        ``exe_cache`` is taken as the constructor's (module docstring)."""
        from ..export import artifact_input_shape, exported_fn, load_exported
        device = resolve_device(device)
        exported = load_exported(path, device)
        b, h, w = artifact_input_shape(exported)
        if b is not None:
            if batch is not None and batch != b:
                raise ValueError(
                    f'artifact {path} was exported at batch {b}, '
                    f'requested {batch}')
            batch = b
        elif batch is None:
            raise ValueError(
                f'artifact {path} has a symbolic batch dim; pass batch=')
        return cls(exported_fn(exported), [(h, w)], int(batch),
                   device=device, name=name, exe_cache=exe_cache)
