"""Builds the port's CUDA kernels with nvcc at first use and loads them
with ctypes.

Each source `ops/csrc/<name>.cu` exposes a plain C interface and becomes
a shared library. A failed build raises: there is no fallback.

Without the compile cache (the default), the library is
`rtseg_tpu_torch/_build/lib<name>.so`, rebuilt when the source or this
builder is newer than it. A build compiles to a temporary name and
renames it into place, so a concurrent process never loads a
half-written file.

With the process's compile cache on (warm/compile_cache.py
`enable_compile_cache`), or a cache handed to `load`, the library is
acquired through that ExeCache (warm/exe_cache.py): keyed by the
source's and this builder's full text, nvcc's command, flags and
version, and the cards; loaded from the cache on a hit, built and stored
on a miss. Either way one `compile` event a library acquired. A library
this process has already loaded stays loaded: it is acquired once.

`build()` starts one nvcc per library at once and waits for them;
`load(name)` builds if needed and returns the loaded library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).parent / 'csrc'
_BUILD = Path(__file__).resolve().parent.parent / '_build'

KERNELS = ('fused_head', 'confusion_matrix')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {name: threading.Lock()
                                     for name in KERNELS}


def _nvcc() -> str:
    for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if home and (Path(home) / 'bin' / 'nvcc').exists():
            return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       'to build the CUDA kernels')


def library_path(name: str) -> Path:
    return _BUILD / f'lib{name}.so'


def _stale(name: str) -> bool:
    so = library_path(name)
    if not so.exists():
        return True
    newest = max((_CSRC / f'{name}.cu').stat().st_mtime,
                 Path(__file__).stat().st_mtime)
    return so.stat().st_mtime < newest


def _nvcc_command(name: str, out: str, extra=()) -> list:
    return [_nvcc(), *NVCC_FLAGS, *extra, '-o', str(out),
            str(_CSRC / f'{name}.cu')]


def _compile(name: str, out: str) -> None:
    """One nvcc build of kernel `name` into `out`; raises RuntimeError
    with nvcc's output when it fails."""
    cmd = _nvcc_command(name, out)
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name} (exit '
                           f'{proc.returncode}):\n{proc.stdout}')


def library_build(name: str):
    """The ExeCache description of kernel `name`'s library."""
    from ..warm.exe_cache import LibraryBuild
    return LibraryBuild(
        name=name,
        sources=((f'{name}.cu', (_CSRC / f'{name}.cu').read_text()),),
        builder=Path(__file__).read_text(),
        command=(_nvcc(), *NVCC_FLAGS),
        compile=lambda out: _compile(name, out))


def _cache(cache=None):
    if cache is not None:
        return cache
    from ..warm.compile_cache import active_cache
    return active_cache()


def build(names: Iterable[str] = KERNELS, force: bool = False,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every stale kernel library in parallel; returns nvcc's
    diagnostics by name (the register and spill report of `ptxas -v` when
    `ptxas_verbose`). Raises RuntimeError naming every failed build.

    With the process's compile cache on (and neither `force` nor
    `ptxas_verbose`, which are diagnostics of `_build/`), each library
    not loaded yet is acquired through the cache instead, one thread a
    library, and loaded; nothing is returned."""
    names = list(names)
    cache = _cache()
    if cache is not None and not force and not ptxas_verbose:
        errors = {}

        def acquire(name):
            try:
                load(name)
            except RuntimeError as e:
                errors[name] = str(e)

        threads = [threading.Thread(target=acquire, args=(n,))
                   for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError('\n'.join(errors.values()))
        return {}
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    extra = ['-Xptxas', '-v'] if ptxas_verbose else []
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f'.{os.getpid()}.tmp.so')
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            _nvcc_command(name, tmp, extra), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f'{name} (exit {proc.returncode}):\n{out}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
            from ..warm.exe_cache import emit_compile_event
            emit_compile_event(name, time.perf_counter() - t0, False,
                               nbytes=library_path(name).stat().st_size)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return logs


def load(name: str, cache=None, event: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library for kernel `name`. The first call of the process
    acquires it: through `cache` (an ExeCache) or the process's compile
    cache when either is given, its compile event named `event` (default:
    `name`); else from `_build/`, built first if stale."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    with _locks[name]:
        if name not in _libs:
            cache = _cache(cache)
            if cache is not None:
                _libs[name], _ = cache.load_or_compile(
                    library_build(name), name=event or name)
            else:
                build([name])
                _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')
