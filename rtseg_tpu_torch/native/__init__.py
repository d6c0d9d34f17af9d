"""Native (C) host routines of the input pipeline, built on first use
(counterpart of rtseg_tpu/native, with the port's own copy of the source).

`host.c` holds the augmentation tail's fused flip + normalize + float32
copy (`normalize_hwc`, `hflip_mask`, as in the JAX package) and the two
routines the port adds to read Cityscapes-sized PNGs without PIL or cv2:
PNG row unfiltering (`png_unfilter`, data/png.py) and the uint8 resizes
(`resize_linear_u8`, `resize_nearest`, data/transforms.py). Each is held
bit-equal to the numpy version beside its caller. ctypes releases the GIL
for the call, so the loader's threads run them in parallel.

Build: one `cc -O3 -ffp-contract=off -shared -fPIC` at first use into
`rtseg_tpu_torch/_build/librtseg_host.so` (rebuilt when host.c or this
file is newer), compiled to a temporary name and renamed into place. If
it fails, `available()` is False, `build_error()` says why, and callers
take the numpy path, as in the JAX package; where the native path is
required (chip_smoke.py on the card) the caller checks `available()`.
`counts()` gives the calls made in this process, by routine.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_SRC = Path(__file__).parent / 'host.c'
_SO = Path(__file__).resolve().parent.parent / '_build' / 'librtseg_host.so'

_lib = None
_tried = False
_error: Optional[str] = None
_lock = threading.Lock()
_counts: Dict[str, int] = {}


def _build() -> Optional[Path]:
    """Compile (or reuse) the library; never raises: a failure is kept
    for build_error() and the callers take the numpy path."""
    global _error
    try:
        newest = max(_SRC.stat().st_mtime, Path(__file__).stat().st_mtime)
        if _SO.exists() and _SO.stat().st_mtime >= newest:
            return _SO
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_suffix(f'.{os.getpid()}.tmp.so')
        # -ffp-contract=off: normalize's px*scale+bias must round twice
        # like the numpy path (and the card's 256-entry table built from
        # it); an fmadd would move it by an ulp
        cmd = [os.environ.get('CC', 'cc'), '-O3', '-ffp-contract=off',
               '-shared', '-fPIC', '-o', str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            _error = f'{" ".join(cmd)} exited {proc.returncode}: ' \
                     f'{proc.stderr.strip()}'
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError) as e:
        _error = f'{type(e).__name__}: {e}'
        return None
    return _SO


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    with _lock:                 # the loader's threads reach here together
        if not _tried:
            so = _build()
            if so is not None:
                try:
                    _lib = _declare(ctypes.CDLL(str(so)))
                except OSError as e:
                    _error = f'dlopen {so}: {e}'
            _tried = True
    return _lib


def _declare(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    long = ctypes.c_long
    for name, src in (('normalize_u8_hwc', u8p), ('normalize_f32_hwc', f32p)):
        fn = getattr(lib, name)
        fn.argtypes = [src, f32p, long, long, long, f32p, f32p, ctypes.c_int]
        fn.restype = None
    lib.hflip_i32_hw.argtypes = [i32p, i32p, long, long]
    lib.hflip_i32_hw.restype = None
    lib.png_unfilter.argtypes = [u8p, u8p, long, long, long]
    lib.png_unfilter.restype = long
    lib.resize_linear_u8.argtypes = [u8p, long, long, u8p, long, long] \
        + [i32p] * 8
    lib.resize_linear_u8.restype = long
    lib.resize_nearest.argtypes = [u8p, long, long, u8p, long, long, i64p,
                                   i64p]
    lib.resize_nearest.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    _load()
    return _error


def counts() -> Dict[str, int]:
    """Native calls made in this process, by routine."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        _counts.clear()


def _count(name: str) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def normalize_hwc(image: np.ndarray, scale: np.ndarray, bias: np.ndarray,
                  hflip: bool = False) -> Optional[np.ndarray]:
    """Fused (hflip +) per-channel scale/bias + float32 contiguous copy of
    a C-contiguous (H, W, C) uint8 or float32 image; None when the library
    is unavailable or the input is another layout (callers take numpy)."""
    lib = _load()
    if lib is None or image.ndim != 3 or not image.flags.c_contiguous:
        return None
    h, w, c = image.shape
    scale = np.ascontiguousarray(scale, np.float32)
    bias = np.ascontiguousarray(bias, np.float32)
    if scale.shape != (c,) or bias.shape != (c,):
        return None
    if image.dtype == np.uint8:
        fn, ctype = lib.normalize_u8_hwc, ctypes.c_uint8
    elif image.dtype == np.float32:
        fn, ctype = lib.normalize_f32_hwc, ctypes.c_float
    else:
        return None
    out = np.empty((h, w, c), np.float32)
    fn(_ptr(image, ctype), _ptr(out, ctypes.c_float), h, w, c,
       _ptr(scale, ctypes.c_float), _ptr(bias, ctypes.c_float), int(hflip))
    _count('normalize_hwc')
    return out


def hflip_mask(mask: np.ndarray) -> Optional[np.ndarray]:
    """(H, W) int32 horizontal flip into a fresh contiguous array."""
    lib = _load()
    if lib is None or mask.ndim != 2 or mask.dtype != np.int32 \
            or not mask.flags.c_contiguous:
        return None
    h, w = mask.shape
    out = np.empty((h, w), np.int32)
    lib.hflip_i32_hw(_ptr(mask, ctypes.c_int32), _ptr(out, ctypes.c_int32),
                     h, w)
    _count('hflip_mask')
    return out


def png_unfilter(data: np.ndarray, h: int, rowbytes: int,
                 bpp: int) -> Optional[np.ndarray]:
    """(h, rowbytes) uint8 rows from `data`, the inflated PNG stream of h
    rows of a filter byte and `rowbytes` bytes. Raises ValueError on a
    filter type outside 0-4; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if data.dtype != np.uint8 or data.size != h * (rowbytes + 1):
        raise ValueError(f'PNG image data holds {data.size} bytes, '
                         f'expected {h} rows of 1 + {rowbytes}')
    data = np.ascontiguousarray(data)
    out = np.empty((h, rowbytes), np.uint8)
    bad = lib.png_unfilter(_ptr(data, ctypes.c_uint8),
                           _ptr(out, ctypes.c_uint8), h, rowbytes, bpp)
    _count('png_unfilter')
    if bad:
        raise ValueError(f'PNG row {bad - 1}: filter type '
                         f'{data[(bad - 1) * (rowbytes + 1)]} is not 0-4')
    return out


def resize_linear_u8(image: np.ndarray, nh: int, nw: int,
                     tables: Sequence[np.ndarray]) -> Optional[np.ndarray]:
    """The fixed-point bilinear resize of an (H, W, C) uint8 image to
    (nh, nw, C), from data/transforms.py's int32 tables (x0, x1, a0, a1,
    y0, y1, b0, b1); None when the library is unavailable."""
    lib = _load()
    if lib is None or image.ndim != 3 or image.dtype != np.uint8:
        return None
    image = np.ascontiguousarray(image)
    _, w, c = image.shape
    tabs = [np.ascontiguousarray(t, np.int32) for t in tables]
    out = np.empty((nh, nw, c), np.uint8)
    rc = lib.resize_linear_u8(_ptr(image, ctypes.c_uint8), w, c,
                              _ptr(out, ctypes.c_uint8), nh, nw,
                              *[_ptr(t, ctypes.c_int32) for t in tabs])
    if rc != 0:
        raise MemoryError(f'resize_linear_u8: no memory for two rows of '
                          f'{nw * c} int32')
    _count('resize_linear_u8')
    return out


def resize_nearest(array: np.ndarray, sy: np.ndarray,
                   sx: np.ndarray) -> Optional[np.ndarray]:
    """array[sy][:, sx] for an (H, W) or (H, W, C) array of any fixed-size
    type; None when the library is unavailable."""
    lib = _load()
    if lib is None or array.ndim not in (2, 3):
        return None
    array = np.ascontiguousarray(array)
    sy = np.ascontiguousarray(sy, np.int64)
    sx = np.ascontiguousarray(sx, np.int64)
    w = array.shape[1]
    psize = array.itemsize * (array.shape[2] if array.ndim == 3 else 1)
    out = np.empty((len(sy), len(sx)) + array.shape[2:], array.dtype)
    lib.resize_nearest(_ptr(array, ctypes.c_uint8), w, psize,
                       _ptr(out, ctypes.c_uint8), len(sy), len(sx),
                       _ptr(sy, ctypes.c_int64), _ptr(sx, ctypes.c_int64))
    _count('resize_nearest')
    return out
