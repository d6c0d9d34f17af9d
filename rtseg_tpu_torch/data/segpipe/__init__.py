"""segpipe, the packed input pipeline (counterpart of
rtseg_tpu/data/segpipe):

  * :mod:`cache`: the packed sample cache, the deterministic decode +
    resize head of every sample built once into fixed-shape mmap shards,
    content-hashed against the dataset's files and transform config (the
    JAX package's layout and key);
  * :mod:`workers`: augment worker processes over a shared-memory ring,
    with the serial path's (seed, epoch, index) determinism;
  * :mod:`prefetch`: the device prefetch thread, and on the card a ring of
    pinned host buffers copied on a side CUDA stream.

The card's half of the raw uint8 tail (flip + normalize inside the steps)
is rtseg_tpu_torch/ops/augment.py.
"""

from .cache import (CacheUnsupported, PackedCache, build_cache, cache_key,
                    open_or_build)
from .prefetch import CardCopier, DevicePrefetcher
from .source import SampleSource, assemble_batch, sample_rngs
from .workers import AugmentPool, shutdown

__all__ = ['AugmentPool', 'CacheUnsupported', 'CardCopier',
           'DevicePrefetcher', 'PackedCache', 'SampleSource',
           'assemble_batch', 'build_cache', 'cache_key', 'open_or_build',
           'sample_rngs', 'shutdown']
