"""The process compile cache (counterpart of
rtseg_tpu/warm/compile_cache.py).

The JAX package points jax's persistent XLA cache at ``<dir>/xla`` for
every compile of the process. The port's compiles are the shared
libraries it builds at first use (warm/exe_cache.py), so the process
cache is one ExeCache under ``<dir>/exe`` through which every later
build goes: ``ops/cuda_build.py``'s ``load``/``build`` (the CUDA
kernels) and ``native/__init__.py``'s host library. A library that the
process has already loaded stays loaded and is not acquired again: like
the JAX call, this must run before the libraries it should cache are
built (the trainer and the serve CLI call it first thing after config
resolution).

This is process-wide state, as jax's config is: ``disable_compile_cache``
turns it off again (tests restore it). Worker processes get it from
their parent explicitly (``settings()``; data/segpipe/workers.py).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from .exe_cache import ExeCache, exe_dir

_lock = threading.Lock()
_active: Optional[ExeCache] = None


def enable_compile_cache(config=None, cache_dir: Optional[str] = None,
                         min_entry_bytes: Optional[int] = None,
                         min_compile_secs: Optional[float] = None) -> str:
    """Send every later library build of this process through an
    ExeCache under ``<dir>/exe``. Pass a resolved SegConfig (its
    ``compile_cache_dir`` and the min-entry/min-compile gates) or
    explicit arguments. Idempotent; returns the entries' directory."""
    global _active
    if config is not None:
        cache_dir = cache_dir or config.compile_cache_dir
        if min_entry_bytes is None:
            min_entry_bytes = config.compile_cache_min_entry_bytes
        if min_compile_secs is None:
            min_compile_secs = config.compile_cache_min_compile_secs
    if not cache_dir:
        raise ValueError('enable_compile_cache needs a cache_dir (resolve '
                         'the config or pass one explicitly)')
    root = exe_dir(cache_dir)
    entry = int(min_entry_bytes or 0)
    secs = float(min_compile_secs or 0.0)
    with _lock:
        cur = _active
        if cur is None or (cur.root, cur.min_entry_bytes,
                           cur.min_compile_secs) != (root, entry, secs):
            _active = ExeCache(root, min_entry_bytes=entry,
                               min_compile_secs=secs)
    return root


def disable_compile_cache() -> None:
    """Builds go to ``_build/`` again, as without the cache."""
    global _active
    with _lock:
        _active = None


def active_cache() -> Optional[ExeCache]:
    """The process's ExeCache, or None when the cache is off."""
    return _active


def settings() -> Optional[Dict[str, Any]]:
    """The keyword arguments that turn the same cache on in another
    process (``enable_compile_cache(**settings())``), or None."""
    cache = _active
    if cache is None:
        return None
    return {'cache_dir': os.path.dirname(cache.root),
            'min_entry_bytes': cache.min_entry_bytes,
            'min_compile_secs': cache.min_compile_secs}
