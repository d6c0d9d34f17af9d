"""Packed sample cache: decode once, mmap forever (counterpart of
rtseg_tpu/data/segpipe/cache.py, with its on-disk layout and key, so each
package reads a cache the other built).

The deterministic ``prepare`` head of every sample (PNG decode + resize)
runs once, packed into fixed-size records in flat binary shards read back
through ``np.memmap``:

  * build: ``dataset.prepare(i)`` for every index, streamed into
    ``data-NNNNN.bin`` shards (record = image bytes + mask bytes) plus an
    ``index.json`` of shapes, dtypes and layout;
  * key: the directory name embeds a sha256 over the dataset's
    ``cache_spec()`` (source paths, sizes, mtimes and the prefix stage's
    transform config) and the format version, so a change to the data or
    the transform head resolves to another directory;
  * reads are zero-copy views into the read-only shard mmap;
  * a build writes a temporary directory and renames it into place, so a
    crashed build never leaves a half-valid index.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Tuple

import numpy as np

#: bump when the on-disk layout changes (the JAX package's value): old
#: caches resolve to another key and are rebuilt, never misread
FORMAT_VERSION = 1

#: target shard size; a record never splits across shards
_SHARD_BYTES = 256 << 20


class CacheUnsupported(Exception):
    """The dataset cannot be packed (ragged prepare() shapes, no
    cache_spec, ...): callers fall back to the decode path."""


def cache_key(dataset) -> str:
    """Content hash naming the cache dir for this dataset + transform
    config. Raises CacheUnsupported when the dataset has no cache_spec."""
    spec_fn = getattr(dataset, 'cache_spec', None)
    if spec_fn is None:
        raise CacheUnsupported(
            f'{type(dataset).__name__} does not implement cache_spec()')
    spec = dict(spec_fn())
    spec['format_version'] = FORMAT_VERSION
    blob = json.dumps(spec, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _record_layout(img: np.ndarray, mask: np.ndarray) -> Dict:
    return {
        'img_shape': list(img.shape), 'img_dtype': str(img.dtype),
        'mask_shape': list(mask.shape), 'mask_dtype': str(mask.dtype),
    }


class PackedCache:
    """Read side: index.json + lazily mmap'd shards. Pickles without its
    mmaps (reopened on first read), so worker processes can carry it."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, 'index.json')) as f:
            idx = json.load(f)
        if idx.get('format_version') != FORMAT_VERSION:
            raise CacheUnsupported(
                f'{path}: format v{idx.get("format_version")} != '
                f'v{FORMAT_VERSION}')
        self.n = int(idx['n'])
        self.samples_per_shard = int(idx['samples_per_shard'])
        self.shards = list(idx['shards'])
        self.img_shape = tuple(idx['img_shape'])
        self.img_dtype = np.dtype(idx['img_dtype'])
        self.mask_shape = tuple(idx['mask_shape'])
        self.mask_dtype = np.dtype(idx['mask_dtype'])
        self._img_bytes = int(np.prod(self.img_shape)) \
            * self.img_dtype.itemsize
        self._mask_bytes = int(np.prod(self.mask_shape)) \
            * self.mask_dtype.itemsize
        self._rec_bytes = self._img_bytes + self._mask_bytes
        self._maps: Dict[int, np.memmap] = {}

    def __len__(self) -> int:
        return self.n

    def __getstate__(self):
        d = dict(self.__dict__)
        d['_maps'] = {}
        return d

    def _shard(self, s: int) -> np.memmap:
        mm = self._maps.get(s)
        if mm is None:
            mm = np.memmap(os.path.join(self.path, self.shards[s]),
                           dtype=np.uint8, mode='r')
            self._maps[s] = mm
        return mm

    def read(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(image, mask) views into the shard mmap: zero-copy, read-only."""
        if not 0 <= index < self.n:
            raise IndexError(index)
        s, r = divmod(index, self.samples_per_shard)
        mm = self._shard(s)
        off = r * self._rec_bytes
        img = np.frombuffer(mm, self.img_dtype,
                            count=int(np.prod(self.img_shape)),
                            offset=off).reshape(self.img_shape)
        mask = np.frombuffer(mm, self.mask_dtype,
                             count=int(np.prod(self.mask_shape)),
                             offset=off + self._img_bytes
                             ).reshape(self.mask_shape)
        return img, mask


def build_cache(dataset, path: str) -> str:
    """Pack every ``dataset.prepare(i)`` into shards under ``path``
    (atomic: temp dir + os.replace). Returns ``path``."""
    n = len(dataset)
    if n == 0:
        raise CacheUnsupported('empty dataset')
    img0, mask0 = dataset.prepare(0)
    img0, mask0 = np.asarray(img0), np.asarray(mask0)
    layout = _record_layout(img0, mask0)
    rec_bytes = img0.nbytes + mask0.nbytes
    sps = max(1, _SHARD_BYTES // rec_bytes)

    parent = os.path.dirname(os.path.abspath(path)) or '.'
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix='.segpack-build-', dir=parent)
    try:
        shards, f, written = [], None, 0
        try:
            for i in range(n):
                img, mask = (img0, mask0) if i == 0 else dataset.prepare(i)
                img, mask = np.asarray(img), np.asarray(mask)
                if (img.shape != img0.shape or img.dtype != img0.dtype
                        or mask.shape != mask0.shape
                        or mask.dtype != mask0.dtype):
                    raise CacheUnsupported(
                        f'sample {i} prepare() shape/dtype '
                        f'{img.shape}/{img.dtype} differs from sample 0 '
                        f'{img0.shape}/{img0.dtype}: packed shards need '
                        f'fixed-shape samples')
                if written % sps == 0:
                    if f is not None:
                        f.close()
                    name = f'data-{len(shards):05d}.bin'
                    shards.append(name)
                    f = open(os.path.join(tmp, name), 'wb')
                f.write(np.ascontiguousarray(img).tobytes())
                f.write(np.ascontiguousarray(mask).tobytes())
                written += 1
        finally:
            if f is not None:
                f.close()
        index = {'format_version': FORMAT_VERSION, 'n': n,
                 'samples_per_shard': sps, 'shards': shards,
                 'record_bytes': rec_bytes, **layout}
        with open(os.path.join(tmp, 'index.json'), 'w') as jf:
            json.dump(index, jf, indent=1)
        if os.path.isdir(path):
            # a concurrent build won the race; keep its result
            shutil.rmtree(tmp)
            return path
        try:
            os.replace(tmp, path)
        except OSError:
            # a concurrent winner renamed its build into place between the
            # check and the rename: adopt it
            if not os.path.exists(os.path.join(path, 'index.json')):
                raise
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def open_or_build(dataset, cache_root: str, process_index: int = 0,
                  process_count: int = 1,
                  build_timeout_s: float = 1800.0) -> PackedCache:
    """Resolve the content-hashed cache dir for ``dataset`` under
    ``cache_root``; build it when absent (rank 0 builds, other ranks poll
    for the index: cache_root must be shared storage for several
    processes)."""
    key = cache_key(dataset)
    path = os.path.join(os.path.expanduser(cache_root),
                        f'{type(dataset).__name__.lower()}-{key}')
    idx = os.path.join(path, 'index.json')
    if not os.path.exists(idx):
        if process_index == 0 or process_count == 1:
            build_cache(dataset, path)
        else:
            deadline = time.monotonic() + build_timeout_s
            while not os.path.exists(idx):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f'rank {process_index}: cache build at {path} did '
                        f'not appear within {build_timeout_s:.0f}s (is '
                        f'cache_dir on shared storage?)')
                time.sleep(0.5)
    cache = PackedCache(path)
    if len(cache) != len(dataset):
        raise CacheUnsupported(
            f'{path}: cached n={len(cache)} != dataset n={len(dataset)} '
            f'(stale key collision?)')
    return cache
