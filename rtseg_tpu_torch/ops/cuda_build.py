"""Builds the port's CUDA kernels with nvcc at first use and loads them
with ctypes.

Each source `ops/csrc/<name>.cu` exposes a plain C interface and becomes
`rtseg_tpu_torch/_build/lib<name>.so` (rebuilt when the source or this
builder is newer than the library). A build compiles to a temporary name
and renames it into place, so a concurrent process never loads a
half-written file. A failed build raises: there is no fallback.

`build()` starts one nvcc per stale source, all at once, and waits for
them; `load(name)` builds if needed and returns the loaded library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).parent / 'csrc'
_BUILD = Path(__file__).resolve().parent.parent / '_build'

KERNELS = ('fused_head', 'confusion_matrix')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


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


def build(names: Iterable[str] = KERNELS, force: bool = False,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every stale kernel library in parallel; returns nvcc's
    diagnostics by name (the register and spill report of `ptxas -v` when
    `ptxas_verbose`). Raises RuntimeError naming every failed build."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ['-Xptxas', '-v'] if ptxas_verbose else []
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f'.{os.getpid()}.tmp.so')
        cmd = [nvcc, *NVCC_FLAGS, *extra, '-o', str(tmp),
               str(_CSRC / f'{name}.cu')]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f'{name} (exit {proc.returncode}):\n{out}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if stale."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')
