"""Native (C) host routines of the input pipeline, built on first use
(counterpart of rtseg_tpu/native, with the port's own copy of the source).

`host.c` holds the augmentation tail's fused flip + normalize + float32
copy (`normalize_hwc`, `hflip_mask`, as in the JAX package) and the two
routines the port adds to read Cityscapes-sized PNGs without PIL or cv2:
PNG row unfiltering (`png_unfilter`, data/png.py) and the uint8 resizes
(`resize_linear_u8`, `resize_nearest`, data/transforms.py). Each is held
bit-equal to the numpy version beside its caller. `jpeg.c` is the JPEG
decoder of data/jpeg.py (`jpeg_header`, `jpeg_decode` and its pixel
stages `jpeg_idct`, `jpeg_upsample`, `jpeg_color`), which has no numpy
path: data/jpeg.py raises with `build_error()` when the library is
missing. ctypes releases the GIL for the call, so the loader's threads
run them in parallel.

Build: one `cc -O3 -ffp-contract=off -shared -fPIC` of both sources at
first use into `rtseg_tpu_torch/_build/librtseg_host.so` (rebuilt when a
source or this file is newer), compiled to a temporary name and renamed
into place. With the process's compile cache on
(warm/compile_cache.py), the library is acquired through that ExeCache
instead: keyed by both sources' and this file's text, the command, its
flags and cc's version; a corrupt entry is a recorded fallback to a
fresh build. Either way one `compile` event when it is acquired. If the
build fails, `available()` is False, `build_error()` says
why, and the callers of host.c's routines take the numpy path, as in the
JAX package; where the native path is required (chip_smoke.py on the
card) the caller checks `available()`. `counts()` gives the calls made in
this process, by routine.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_SRCS = (Path(__file__).parent / 'host.c', Path(__file__).parent / 'jpeg.c')
_SO = Path(__file__).resolve().parent.parent / '_build' / 'librtseg_host.so'

_lib = None
_tried = False
_error: Optional[str] = None
_lock = threading.Lock()
_counts: Dict[str, int] = {}


def _command() -> list:
    # -ffp-contract=off: normalize's px*scale+bias must round twice like
    # the numpy path (and the card's 256-entry table built from it); an
    # fmadd would move it by an ulp
    return [os.environ.get('CC', 'cc'), '-O3', '-ffp-contract=off',
            '-shared', '-fPIC']


def _compile(out) -> None:
    """One cc build of both sources into `out`; raises RuntimeError with
    cc's output when it fails."""
    cmd = [*_command(), '-o', str(out), *map(str, _SRCS)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f'{" ".join(cmd)} exited {proc.returncode}: '
                           f'{proc.stderr.strip()}')


def library_build():
    """The ExeCache description of the host library."""
    from ..warm.exe_cache import LibraryBuild
    return LibraryBuild(
        name='rtseg_host',
        sources=tuple((p.name, p.read_text()) for p in _SRCS),
        builder=Path(__file__).read_text(), command=tuple(_command()),
        compile=_compile, device=False)


def _build() -> Optional[Path]:
    """Compile (or reuse) the library in `_build/`; never raises: a
    failure is kept for build_error() and the callers take the numpy
    path."""
    global _error
    try:
        newest = max(p.stat().st_mtime
                     for p in (*_SRCS, Path(__file__)))
        if _SO.exists() and _SO.stat().st_mtime >= newest:
            return _SO
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_suffix(f'.{os.getpid()}.tmp.so')
        t0 = time.perf_counter()
        try:
            _compile(tmp)
        except RuntimeError as e:
            _error = str(e)
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, _SO)
        from ..warm.exe_cache import emit_compile_event
        emit_compile_event('rtseg_host', time.perf_counter() - t0, False,
                           nbytes=_SO.stat().st_size)
    except (OSError, subprocess.SubprocessError) as e:
        _error = f'{type(e).__name__}: {e}'
        return None
    return _SO


def _acquire():
    """The library (undeclared) through the process's compile cache, or
    from `_build/`; None with `_error` set when it cannot be had."""
    global _error
    from ..warm.compile_cache import active_cache
    cache = active_cache()
    if cache is None:
        so = _build()
        if so is None:
            return None
        try:
            return ctypes.CDLL(str(so))
        except OSError as e:
            _error = f'dlopen {so}: {e}'
            return None
    try:
        lib, _ = cache.load_or_compile(library_build())
        return lib
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _error = f'{type(e).__name__}: {e}'
        return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:                 # the loader's threads reach here together
        if not _tried:
            lib = _acquire()
            _lib = None if lib is None else _declare(lib)
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
    i16p = ctypes.POINTER(ctypes.c_int16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.jpeg_header.argtypes = [u8p, long, i32p, ctypes.c_char_p, long]
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [u8p, long, u8p, i16p, u16p, i32p,
                                ctypes.c_char_p, long]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_idct_islow_blocks.argtypes = [i16p, u16p, long, long, u8p]
    lib.jpeg_idct_islow_blocks.restype = None
    lib.jpeg_upsample.argtypes = [u8p, long, long, long, ctypes.c_int,
                                  ctypes.c_int, u8p, long, long]
    lib.jpeg_upsample.restype = ctypes.c_int
    lib.jpeg_color.argtypes = [u8p, u8p, u8p, ctypes.c_int, u8p, long]
    lib.jpeg_color.restype = None
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


# ------------------------------------------------------------------- JPEG

JPEG_CORRUPT, JPEG_UNSUPPORTED, JPEG_NOMEM = -1, -2, -3


def _jpeg_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f'the JPEG decoder is native code only, and the '
                           f'native library did not build: {build_error()}')
    return lib


def _jpeg_raise(rc: int, err) -> None:
    msg = err.value.decode(errors='replace')
    if rc == JPEG_UNSUPPORTED:
        raise NotImplementedError(msg)
    if rc == JPEG_NOMEM:
        raise MemoryError(msg)
    raise ValueError(msg)


def jpeg_header(data: bytes) -> Dict[str, object]:
    """The frame header of a JPEG: {'height', 'width', 'components',
    'progressive', 'factors': [(h, v) a component]}. Raises ValueError
    (corrupt), NotImplementedError (a frame the decoder refuses)."""
    lib = _jpeg_lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(10, np.int32)
    err = ctypes.create_string_buffer(256)
    rc = lib.jpeg_header(_ptr(buf, ctypes.c_uint8), buf.size,
                         _ptr(info, ctypes.c_int32), err, 256)
    if rc:
        _jpeg_raise(rc, err)
    n = int(info[2])
    return {'height': int(info[0]), 'width': int(info[1]), 'components': n,
            'progressive': bool(info[3]),
            'factors': [(int(info[4 + 2 * i]), int(info[5 + 2 * i]))
                        for i in range(n)]}


def jpeg_decode(data: bytes, coefficients: bool = False):
    """(H, W, 3) uint8 RGB of a JPEG. With `coefficients`, also a dict of
    the decoded stream's coefficients before the pixel stages:
    {'coef': [(blocks high, blocks wide, 64) int16 a component, natural
    order, as decoded], 'qt': (components, 64) uint16, 'space': 0 gray,
    1 YCbCr, 2 RGB}. Raises as jpeg_header does."""
    lib = _jpeg_lib()
    head = jpeg_header(data)
    h, w = head['height'], head['width']
    factors = head['factors']
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    coef = qt = space = None
    shapes = []
    if coefficients:
        hmax = max(f[0] for f in factors)
        vmax = max(f[1] for f in factors)
        for fh, fv in factors:
            if len(factors) == 1:
                shapes.append((-(-h // 8), -(-w // 8)))
            else:
                shapes.append((-(-h // (8 * vmax)) * fv,
                               -(-w // (8 * hmax)) * fh))
        coef = np.zeros(sum(a * b for a, b in shapes) * 64, np.int16)
        qt = np.zeros((len(factors), 64), np.uint16)
        space = np.zeros(1, np.int32)
    rc = lib.jpeg_decode(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(out, ctypes.c_uint8),
        None if coef is None else _ptr(coef, ctypes.c_int16),
        None if qt is None else _ptr(qt, ctypes.c_uint16),
        None if space is None else _ptr(space, ctypes.c_int32), err, 256)
    _count('jpeg_decode')
    if rc:
        _jpeg_raise(rc, err)
    if not coefficients:
        return out
    parts, off = [], 0
    for bh, bw in shapes:
        parts.append(coef[off:off + bh * bw * 64].reshape(bh, bw, 64))
        off += bh * bw * 64
    return out, {'coef': parts, 'qt': qt, 'space': int(space[0])}


def jpeg_idct(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(bh*8, bw*8) uint8 samples of (bh, bw, 64) int16 blocks (natural
    order) through dequantization by the 64-entry `qt` and the ISLOW
    IDCT."""
    lib = _jpeg_lib()
    coef = np.ascontiguousarray(coef, np.int16)
    qt = np.ascontiguousarray(qt, np.uint16)
    if coef.ndim != 3 or coef.shape[2] != 64 or qt.shape != (64,):
        raise ValueError(f'jpeg_idct takes (bh, bw, 64) blocks and 64 '
                         f'table entries, got {coef.shape} and {qt.shape}')
    bh, bw = coef.shape[:2]
    out = np.empty((bh * 8, bw * 8), np.uint8)
    lib.jpeg_idct_islow_blocks(_ptr(coef, ctypes.c_int16),
                               _ptr(qt, ctypes.c_uint16), bh, bw,
                               _ptr(out, ctypes.c_uint8))
    return out


def jpeg_upsample(plane: np.ndarray, dh: int, dw: int, hr: int, vr: int,
                  oh: int, ow: int) -> np.ndarray:
    """The (oh, ow) top-left of the (dh, dw) top-left of `plane`
    upsampled by (hr, vr), as the decoder does it."""
    lib = _jpeg_lib()
    plane = np.ascontiguousarray(plane, np.uint8)
    if plane.ndim != 2 or not (0 < dh <= plane.shape[0]
                               and 0 < dw <= plane.shape[1]
                               and 0 < oh <= dh * vr and 0 < ow <= dw * hr):
        raise ValueError(f'jpeg_upsample: ({dh}, {dw}) of a plane of '
                         f'{plane.shape} to ({oh}, {ow}) by ({hr}, {vr})')
    out = np.empty((oh, ow), np.uint8)
    rc = lib.jpeg_upsample(_ptr(plane, ctypes.c_uint8), plane.shape[1], dh,
                           dw, hr, vr, _ptr(out, ctypes.c_uint8), oh, ow)
    if rc:
        raise NotImplementedError(f'upsampling by ({hr}, {vr})')
    return out


def jpeg_color(planes: Sequence[np.ndarray], space: int) -> np.ndarray:
    """(H, W, 3) RGB of one gray plane or three planes of colour space
    `space` (1 YCbCr, 2 RGB)."""
    lib = _jpeg_lib()
    planes = [np.ascontiguousarray(p, np.uint8) for p in planes]
    if len(planes) not in (1, 3) or planes[0].ndim != 2 or any(
            p.shape != planes[0].shape for p in planes):
        raise ValueError(f'jpeg_color takes 1 or 3 planes of one 2-D '
                         f'shape, got {[p.shape for p in planes]}')
    h, w = planes[0].shape
    out = np.empty((h, w, 3), np.uint8)
    ptrs = [_ptr(p, ctypes.c_uint8) for p in planes]
    if len(ptrs) == 1:
        ptrs += [None, None]
    lib.jpeg_color(*ptrs, space, _ptr(out, ctypes.c_uint8), h * w)
    return out
