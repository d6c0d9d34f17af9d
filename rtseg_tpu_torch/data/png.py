"""PNG files in zlib and numpy: the port's replacement for
`PIL.Image.open(path).convert('RGB' | 'L')` (rtseg_tpu/data/protocol.py),
whose machines with a card have no PIL.

`read(path, mode)` decodes non-interlaced PNGs of colour types 0 (gray),
2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA) at bit depth 8, and
palette images at depths 1, 2 and 4, with any number of IDAT chunks and
the five row filters, and converts them as PIL does:
  * 'RGB': gray replicated, palette looked up, alpha and tRNS dropped;
  * 'L':   RGB (and a palette's colours) as
           (R*19595 + G*38470 + B*7471 + 0x8000) >> 16, alpha dropped.
Interlaced files, 16-bit samples and gray below 8 bits raise ValueError.
The row unfilter runs in the native library (native.png_unfilter) when it
is built; `unfilter_numpy` is the reference it is held to, a per-pixel
loop for the Average and Paeth filters (seconds at 1024x2048).

`encode(array)` writes gray or RGB 8-bit PNGs, cycling the filter types
row by row when asked: prediction's masks and blends, the server's
responses, the tests' and chip_smoke.py's trees. `read_size(path)` reads
the IHDR alone. data/image.py sends each file here or to data/jpeg.py by
its signature.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

from .. import native

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_size(path: str):
    """(height, width) of a PNG from its IHDR chunk alone (the first 33
    bytes), without decoding it."""
    with open(path, 'rb') as f:
        head = f.read(33)
    kind, body = next(_chunks(head))
    if kind != b'IHDR':
        raise ValueError(f'{path}: the first PNG chunk is {kind!r}, not IHDR')
    w, h = struct.unpack('>II', body[:8])
    return h, w


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file (bad signature)')
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f'PNG chunk {kind!r} is truncated')
        if zlib.crc32(kind + body) != struct.unpack('>I', crc)[0]:
            raise ValueError(f'PNG chunk {kind!r} fails its CRC')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + length
    raise ValueError('PNG file ends before IEND')


def unfilter_numpy(data: np.ndarray, h: int, rowbytes: int,
                   bpp: int) -> np.ndarray:
    """The reference unfilter: (h, rowbytes) uint8 rows."""
    if data.size != h * (rowbytes + 1):
        raise ValueError(f'PNG image data holds {data.size} bytes, '
                         f'expected {h} rows of 1 + {rowbytes}')
    rows = data.reshape(h, rowbytes + 1)
    out = np.empty((h, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            out[y] = line
        elif ft == 1:
            pad = -rowbytes % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            out[y] = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)[:rowbytes]
        elif ft == 2:
            out[y] = line + prev
        elif ft in (3, 4):
            cur = [0] * rowbytes
            up = prev.tolist()
            src = line.tolist()
            for i in range(rowbytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 0xFF
            out[y] = cur
        else:
            raise ValueError(f'PNG row {y}: filter type {ft} is not 0-4')
        prev = out[y]
    return out


def _l_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L (ITU-R 601-2 luma in 16-bit fixed point)."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def decode(data: bytes, mode: str) -> np.ndarray:
    """(H, W, 3) uint8 for mode 'RGB', (H, W) uint8 for 'L'."""
    if mode not in ('RGB', 'L'):
        raise ValueError(f"mode must be 'RGB' or 'L', got {mode!r}")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG file has no IHDR chunk')
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError('interlaced PNG files are not supported')
    if ctype not in _CHANNELS:
        raise ValueError(f'PNG colour type {ctype} is not defined')
    if depth == 16:
        raise ValueError('16-bit PNG files are not supported')
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f'PNG colour type {ctype} at bit depth {depth} is '
                         f'not supported')
    if ctype == 3 and palette is None:
        raise ValueError('palette PNG file has no PLTE chunk')
    channels = _CHANNELS[ctype]
    rowbytes = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    rows = native.png_unfilter(raw, h, rowbytes, bpp)
    if rows is None:
        rows = unfilter_numpy(raw, h, rowbytes, bpp)

    if ctype == 3:
        if depth < 8:
            per = 8 // depth
            shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
            rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)
                    ).reshape(h, -1)[:, :w]
        else:
            rows = rows.reshape(h, w)
        if rows.max(initial=0) >= len(palette):
            raise ValueError(f'PNG palette index {int(rows.max())} past the '
                             f'{len(palette)} colours of PLTE')
        rgb = palette[rows]
        return rgb if mode == 'RGB' else _l_from_rgb(rgb)
    pixels = rows.reshape(h, w, channels)
    if ctype in (0, 4):
        gray = pixels[..., 0]
        return np.repeat(gray[..., None], 3, axis=2) if mode == 'RGB' \
            else np.ascontiguousarray(gray)
    rgb = pixels[..., :3]
    return np.ascontiguousarray(rgb) if mode == 'RGB' else _l_from_rgb(rgb)


def read(path: str, mode: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert(mode))` for mode 'RGB' or
    'L', without PIL."""
    with open(path, 'rb') as f:
        return decode(f.read(), mode)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def encode(array: np.ndarray, filters: Sequence[int] = (0,),
           idat_chunks: int = 1, level: int = 6) -> bytes:
    """An 8-bit gray (H, W) or RGB (H, W, 3) PNG; row y takes filter
    filters[y % len(filters)], and the zlib stream is split over
    `idat_chunks` IDAT chunks."""
    array = np.ascontiguousarray(array, np.uint8)
    if array.ndim == 2:
        ctype, bpp = 0, 1
    elif array.ndim == 3 and array.shape[2] == 3:
        ctype, bpp = 2, 3
    else:
        raise ValueError(f'encode takes (H, W) or (H, W, 3), got '
                         f'{array.shape}')
    h, w = array.shape[:2]
    rows = array.reshape(h, w * bpp)
    kinds = np.array([filters[y % len(filters)] for y in range(h)])
    out = np.empty((h, w * bpp + 1), np.uint8)
    out[:, 0] = kinds
    if kinds.any():                 # the predictors of filters 1-4
        x = rows.astype(np.int32)
        left = np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
        up = np.zeros_like(x)
        up[1:] = x[:-1]
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, upleft))
        preds = (None, left, up, (left + up) >> 1, paeth)
    for k in set(kinds.tolist()):
        sel = kinds == k
        out[sel, 1:] = (rows[sel] if k == 0
                        else (x[sel] - preds[k][sel]) & 0xFF)
    stream = zlib.compress(out.tobytes(), level)
    step = -(-len(stream) // max(1, idat_chunks))
    parts = [stream[i:i + step] for i in range(0, len(stream), step)] or [b'']
    header = struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b'IHDR', header)
            + b''.join(_chunk(b'IDAT', part) for part in parts)
            + _chunk(b'IEND', b''))
