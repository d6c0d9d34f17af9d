"""ExeCache — the port's compiled libraries keyed by a content hash
(counterpart of rtseg_tpu/warm/exe_cache.py).

What the port compiles is not a program per step but the shared
libraries it builds from its own sources at first use: the CUDA kernels
(`ops/cuda_build.py`: `libfused_head.so`, `libconfusion_matrix.so`, nvcc
for sm_90a) and the host routines (`native/__init__.py`:
`librtseg_host.so`, cc). A `torch.compile` or AOTInductor program is not
cached (its fused code rounds differently from the eager path), nor a
captured CUDA graph (it cannot be loaded in another process): a hit must
be bit-identical to the path without the cache, and a library built from
the same sources by the same compiler with the same flags is that.

The cache key keeps the JAX package's construction (sha256 over the JSON
of versions, backend, pins and `extra`, a zero byte, then the program
text), so the same inputs give the same hex digest in both packages. The
program text of a library is its `LibraryBuild.program_text()`: the full
text of every source, the full text of the builder module, and the
compiler command with its flags. The rest of the key:

  * the versions: torch, the CUDA runtime torch was built for, and the
    compiler's `--version` text (an upgraded toolkit misses, where the
    mtime check of `_build/` kept a stale library);
  * the backend: for a CUDA library the device names, compute
    capabilities, device count and world size, for the host library the
    machine; either way the environment variables that change codegen
    (`CODEGEN_ENV`);
  * the pins (`PIN_KEYS`) and the caller's `extra`.

Layout under `root`, as the JAX cache's: `<key>.exe` (the library's
bytes) with a `<key>.json` sidecar in the JAX sidecar's fields plus the
bytes' `sha256`, and `fallbacks.jsonl`. A hit reads the entry, checks it
against the sidecar's sha256, and dlopens exactly the bytes it checked
(from a private copy in the temporary directory, unlinked once loaded,
so a later rewrite or truncation of the entry never touches a loaded
library, and a read-only cache directory still serves hits). A miss builds
into a temporary name, stores the bytes by an atomic rename and loads
them. Any load error (a truncated or corrupt file, a sha mismatch, an
`OSError` from dlopen) warns, appends to `fallbacks.jsonl` and builds the
same library afresh: the fallback is a fresh build of the same kernel,
never its plain version and never the CPU. A failed build raises.

Module-level code imports the standard library alone; torch is imported
inside functions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import platform
import subprocess
import tempfile
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

#: pins folded into every key, as the JAX package's (its
#: analysis/recompile.py PIN_ATTRS): the port's steps carry them as
#: attributes (train/step.py), the engine states them (make_pins)
PIN_KEYS = ('bn_axis', 's2d_stem', 'defer_upsample')

#: environment variables that change what a build produces: nvcc's extra
#: flags and host compiler, the C compiler, the header and library search
#: paths both compilers read
CODEGEN_ENV = ('NVCC_APPEND_FLAGS', 'NVCC_PREPEND_FLAGS', 'NVCC_CCBIN',
               'CC', 'CPATH', 'C_INCLUDE_PATH', 'CPLUS_INCLUDE_PATH',
               'LIBRARY_PATH')

_EXE_SUFFIX = '.exe'
_META_SUFFIX = '.json'
_FALLBACK_LOG = 'fallbacks.jsonl'


def exe_dir(cache_dir: str) -> str:
    """Where entries live under a cache dir (the JAX layout's ``exe/``)."""
    return os.path.join(os.path.abspath(cache_dir), 'exe')


@dataclass(frozen=True)
class LibraryBuild:
    """How one shared library is built: its `name`, the (file name, full
    text) of each source, the full text of the builder module, the
    compiler command with its flags (no output or input paths, which
    differ between checkouts), and `compile(out)`, which builds the
    library at path `out` and raises on failure. `device` says whether
    the library is device code (its key then holds the cards)."""
    name: str
    sources: Tuple[Tuple[str, str], ...]
    builder: str
    command: Tuple[str, ...]
    compile: Callable[[str], None]
    device: bool = True

    def program_text(self) -> str:
        return json.dumps({'name': self.name,
                           'sources': [list(s) for s in self.sources],
                           'builder': self.builder,
                           'command': list(self.command)}, sort_keys=True)


def world_size() -> int:
    """The process group's size (the launcher's WORLD_SIZE before the
    group opens; 1 without either)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', '1') or 1)


def backend_fingerprint(device: bool = True) -> Dict[str, Any]:
    """The machine part of the key. For device code: the platform, the
    cards' names and compute capabilities, their count and the world
    size. For host code: the machine's architecture (no card is asked,
    so a worker process never initializes CUDA). Either way the
    codegen environment variables."""
    env = {k: os.environ.get(k, '') for k in CODEGEN_ENV}
    if not device:
        return {'platform': 'host', 'machine': platform.machine(),
                'env': env}
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        'platform': 'cuda' if n else 'cpu',
        'device_kinds': sorted({torch.cuda.get_device_name(i)
                                for i in range(n)}),
        'capabilities': sorted({'%d.%d' % torch.cuda.get_device_capability(i)
                                for i in range(n)}),
        'n_devices': n,
        'world_size': world_size(),
        'env': env,
    }


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """`<compiler> --version`'s text ('' when it cannot run)."""
    try:
        proc = subprocess.run([compiler, '--version'], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ''
    return proc.stdout.strip()


def _versions(compilers: Sequence[str] = ()) -> Dict[str, str]:
    import torch
    out = {'torch': torch.__version__, 'cuda': str(torch.version.cuda)}
    for c in compilers:
        out[os.path.basename(c)] = compiler_version(c)
    return out


def cache_key(lowered_text: str, pins: Optional[Dict[str, Any]] = None,
              extra: Any = None,
              versions: Optional[Dict[str, str]] = None,
              backend: Optional[Dict[str, Any]] = None) -> str:
    """Content hash for one program text (the JAX construction).
    ``versions``/``backend`` default to the live process."""
    ident = {
        'versions': versions if versions is not None else _versions(),
        'backend': backend if backend is not None else backend_fingerprint(),
        'pins': {k: repr(v) for k, v in sorted((pins or {}).items())},
        'extra': repr(extra) if extra is not None else None,
    }
    h = hashlib.sha256()
    h.update(json.dumps(ident, sort_keys=True).encode())
    h.update(b'\x00')
    h.update(lowered_text.encode())
    return h.hexdigest()


def emit_compile_event(name: str, dur_s: float, cache_hit: bool,
                       nbytes: Optional[int] = None,
                       key: Optional[str] = None, **attrs: Any) -> None:
    """The ``compile`` event (the JAX package's keys): one a library
    acquired, flagged with whether the cache served it. obs/report.py
    sums them into the cold and warm startup-compile seconds."""
    from ..obs import get_sink
    sink = get_sink()
    if sink is None:
        return
    ev: Dict[str, Any] = {'event': 'compile', 'name': name,
                          'dur_s': round(dur_s, 6), 'cache_hit': cache_hit}
    if nbytes is not None:
        ev['bytes'] = int(nbytes)
    if key is not None:
        ev['key'] = key[:16]
    ev.update(attrs)
    sink.emit(ev)


def fresh_build(build: LibraryBuild) -> Tuple[ctypes.CDLL, bytes]:
    """Build `build` into a private temporary file and load it: (the
    library, its bytes). Raises what the build raises."""
    fd, tmp = tempfile.mkstemp(prefix=f'.{build.name}-', suffix='.so')
    os.close(fd)
    try:
        build.compile(tmp)
        with open(tmp, 'rb') as f:
            blob = f.read()
        return ctypes.CDLL(tmp), blob
    finally:
        _unlink(tmp)


def timed_compile(build: LibraryBuild, name: str,
                  cache: Optional['ExeCache'] = None,
                  pins: Optional[Dict[str, Any]] = None):
    """(library, seconds, label) for one build — through ``cache`` when
    given (labels ``warm cache-hit`` / ``warm miss, stored``), else a
    fresh build (``cold``); one ``compile`` event either way."""
    t0 = time.perf_counter()
    if cache is not None:
        lib, hit = cache.load_or_compile(build, name=name, pins=pins)
        return (lib, time.perf_counter() - t0,
                'warm cache-hit' if hit else 'warm miss, stored')
    lib, _ = fresh_build(build)
    dur = time.perf_counter() - t0
    emit_compile_event(name, dur, False)
    return lib, dur, 'cold'


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f'{path}.tmp.{os.getpid()}.{threading.get_ident()}'
    with open(tmp, 'wb') as f:
        f.write(data)
    os.replace(tmp, path)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class ExeCache:
    """On-disk cache of built libraries (layout: module docstring).

    Thread-safe; processes may share a directory: entries are written by
    tmp+rename, and the sidecar's hit count is updated under a file lock,
    so torchrun's ranks never tear a sidecar or lose a count.
    """

    @classmethod
    def from_config(cls, config) -> 'ExeCache':
        """Entries under ``compile_cache_dir/exe`` with the config's store
        gates."""
        return cls(exe_dir(config.compile_cache_dir),
                   min_entry_bytes=config.compile_cache_min_entry_bytes,
                   min_compile_secs=config.compile_cache_min_compile_secs)

    @classmethod
    def at(cls, cache_dir: str) -> 'ExeCache':
        """ExeCache under a bare cache dir (default store gates)."""
        return cls(exe_dir(cache_dir))

    def __init__(self, root: str, min_entry_bytes: int = 0,
                 min_compile_secs: float = 0.0):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.min_entry_bytes = int(min_entry_bytes)
        self.min_compile_secs = float(min_compile_secs)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.fallbacks = 0            # entry present but unloadable
        self.store_failures = 0
        self.stats_failures = 0       # sidecar hit-count updates that raised
        self.bytes_read = 0
        self.bytes_written = 0
        self.hit_s = 0.0              # read + check + dlopen
        self.miss_s = 0.0             # fresh build + load

    def _exe_path(self, key: str) -> str:
        return os.path.join(self.root, key + _EXE_SUFFIX)

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.root, key + _META_SUFFIX)

    def key_of(self, build: LibraryBuild,
               pins: Optional[Dict[str, Any]] = None,
               extra: Any = None) -> str:
        return cache_key(build.program_text(), pins=pins, extra=extra,
                         versions=_versions(build.command[:1]),
                         backend=backend_fingerprint(build.device))

    def load_or_compile(self, build: LibraryBuild, name: Optional[str] = None,
                        pins: Optional[Dict[str, Any]] = None,
                        extra: Any = None) -> Tuple[ctypes.CDLL, bool]:
        """Load the stored library for ``build`` if a good entry exists,
        else build, store and load it. Returns ``(library, cache_hit)``
        and emits one ``compile`` event either way. A failed build
        raises."""
        name = name or build.name
        key = self.key_of(build, pins, extra)
        t0 = time.perf_counter()
        lib, nbytes = self._try_load(key, name)
        if lib is not None:
            dur = time.perf_counter() - t0
            with self._lock:
                self.hits += 1
                self.hit_s += dur
                self.bytes_read += nbytes
            self._bump_hit(key)
            emit_compile_event(name, dur, True, nbytes=nbytes, key=key)
            return lib, True
        # a fallback's failed read must not count as build seconds
        t0 = time.perf_counter()
        lib, blob = fresh_build(build)
        dur = time.perf_counter() - t0
        with self._lock:
            self.misses += 1
            self.miss_s += dur
        stored = self._try_store(key, name, blob, dur, pins, build)
        emit_compile_event(name, dur, False, nbytes=stored, key=key)
        return lib, False

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                'root': self.root, 'hits': self.hits, 'misses': self.misses,
                'fallbacks': self.fallbacks,
                'store_failures': self.store_failures,
                'bytes_read': self.bytes_read,
                'bytes_written': self.bytes_written,
                'hit_s': round(self.hit_s, 4),
                'miss_s': round(self.miss_s, 4),
            }

    def _try_load(self, key: str, name: str
                  ) -> Tuple[Optional[ctypes.CDLL], int]:
        """(library, bytes) on a good hit; (None, 0) on a miss or on any
        load error, which is recorded as a fallback."""
        path = self._exe_path(key)
        if not os.path.exists(path):
            return None, 0
        try:
            with open(path, 'rb') as f:
                blob = f.read()
            with open(self._meta_path(key)) as f:
                want = json.load(f)['sha256']
            got = _sha256(blob)
            if got != want:
                raise ValueError(f'{len(blob)} bytes of sha256 {got[:16]}…, '
                                 f'the sidecar says {want[:16]}…')
            # the private copy goes to the temporary directory: a cache
            # that is read-only (baked into an image, a read-only mount)
            # still serves hits
            fd, tmp = tempfile.mkstemp(prefix=f'.{name}-load-',
                                       suffix='.so')
            try:
                with os.fdopen(fd, 'wb') as f:
                    f.write(blob)
                lib = ctypes.CDLL(tmp)
            finally:
                _unlink(tmp)
            return lib, len(blob)
        except (OSError, ValueError, KeyError) as e:
            self._record_fallback(key, name, e)
            return None, 0

    def _try_store(self, key: str, name: str, blob: bytes, compile_s: float,
                   pins: Optional[Dict[str, Any]],
                   build: LibraryBuild) -> Optional[int]:
        """Write one entry; the stored bytes, or None when a gate skipped
        it or the write failed (the fresh build stays loaded)."""
        if compile_s < self.min_compile_secs or \
                len(blob) < self.min_entry_bytes:
            return None
        try:
            meta = {
                'key': key, 'name': name, 'created': time.time(),
                'compile_s': round(compile_s, 4), 'bytes': len(blob),
                'sha256': _sha256(blob),
                'pins': {k: repr(v) for k, v in sorted((pins or {}).items())},
                'hits': 0,
                **_versions(build.command[:1]),
                **backend_fingerprint(build.device),
            }
            # (a cleared cache has lost its directory) the sidecar first:
            # a reader that finds the entry finds its sha256
            os.makedirs(self.root, exist_ok=True)
            _atomic_write(self._meta_path(key),
                          json.dumps(meta, indent=1).encode())
            _atomic_write(self._exe_path(key), blob)
            with self._lock:
                self.bytes_written += len(blob)
            return len(blob)
        except OSError as e:
            with self._lock:
                self.store_failures += 1
            warnings.warn(f'segwarm: could not store {name!r} in the cache '
                          f'({type(e).__name__}: {e}); this run keeps its '
                          f'fresh build', stacklevel=3)
            return None

    def _bump_hit(self, key: str) -> None:
        """The sidecar's hit count and last use, updated under an
        advisory lock on a ``.lock`` sibling and rewritten by tmp+rename,
        so concurrent processes neither lose counts nor tear it."""
        meta_path = self._meta_path(key)
        try:
            lock_f = open(meta_path + '.lock', 'a')
        except OSError:
            with self._lock:
                self.stats_failures += 1
            return
        try:
            import fcntl
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            with open(meta_path) as f:
                meta = json.load(f)
            meta['hits'] = int(meta.get('hits', 0)) + 1
            meta['last_used'] = time.time()
            _atomic_write(meta_path, json.dumps(meta, indent=1).encode())
        except (OSError, ValueError):
            with self._lock:
                self.stats_failures += 1
        finally:
            lock_f.close()    # releases the flock

    def _record_fallback(self, key: str, name: str, err: Exception) -> None:
        with self._lock:
            self.fallbacks += 1
        warnings.warn(f'segwarm: cached library for {name!r} '
                      f'({key[:16]}…) failed to load '
                      f'({type(err).__name__}: {err}); falling back to a '
                      f'fresh build', stacklevel=3)
        line = json.dumps({'ts': time.time(), 'key': key, 'name': name,
                           'error': f'{type(err).__name__}: {err}'})
        try:
            with self._lock:
                with open(os.path.join(self.root, _FALLBACK_LOG), 'a') as f:
                    f.write(line + '\n')
        except OSError:
            pass


def scan_cache(cache_dir: str) -> Dict[str, Any]:
    """One cache directory's entries, sidecars and fallback log (and the
    JAX package's ``xla/`` files, none in the port's), as
    `tools/torch_segwarm.py stats` prints them. Standard library only."""
    cache_dir = os.path.abspath(cache_dir)
    entries_dir = exe_dir(cache_dir)
    entries = []
    if os.path.isdir(entries_dir):
        for fn in sorted(os.listdir(entries_dir)):
            if not fn.endswith(_META_SUFFIX):
                continue
            try:
                with open(os.path.join(entries_dir, fn)) as f:
                    entries.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue
    fallbacks = []
    fb_path = os.path.join(entries_dir, _FALLBACK_LOG)
    if os.path.exists(fb_path):
        with open(fb_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    fallbacks.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    xla_dir = os.path.join(cache_dir, 'xla')
    xla_files = []
    if os.path.isdir(xla_dir):
        for dirpath, _, filenames in os.walk(xla_dir):
            xla_files.extend(os.path.join(dirpath, fn) for fn in filenames)
    return {
        'cache_dir': cache_dir,
        'entries': entries,
        'n_entries': len(entries),
        'bytes': sum(int(e.get('bytes', 0)) for e in entries),
        'hits': sum(int(e.get('hits', 0)) for e in entries),
        'fallbacks': fallbacks,
        'n_fallbacks': len(fallbacks),
        'xla_entries': len(xla_files),
        'xla_bytes': sum(os.path.getsize(p) for p in xla_files
                         if os.path.exists(p)),
    }


def clear_cache(cache_dir: str) -> int:
    """Remove every cached file (entries, sidecars, locks, the fallback
    log, and ``xla/``) under ``cache_dir``; returns the files removed."""
    import shutil
    removed = 0
    for sub in ('exe', 'xla'):
        d = os.path.join(os.path.abspath(cache_dir), sub)
        if not os.path.isdir(d):
            continue
        for dirpath, _, filenames in os.walk(d):
            removed += len(filenames)
        shutil.rmtree(d)
    return removed
