"""JPEG files for the port: the replacement of
`PIL.Image.open(f).convert('RGB' | 'L')` (rtseg_tpu/data/protocol.py,
test_folder.py, serve/server.py), whose machines with a card have no PIL.

`decode(data, mode)` goes through the native decoder
(rtseg_tpu_torch/native/jpeg.c), which gives libjpeg's default
decompression integer for integer: baseline, extended-sequential and
progressive Huffman frames of 8-bit gray or 3-component samples,
restart markers, the ISLOW IDCT, fancy upsampling and the fixed-point
YCbCr -> RGB tables. Mode 'L' of a colour file is PIL's RGB -> L of
that RGB; of a gray file, the gray plane itself. A truncated or corrupt
file raises ValueError; a frame the decoder does not take (arithmetic
coding, lossless and hierarchical frames, 12-bit samples, 2- and
4-component frames, sampling factors other than 4:4:4, 4:2:2, 4:2:0 and
4:4:0) raises NotImplementedError. There is no Python decoder to fall
back on: without the native library a decode raises, naming
`native.build_error()`.

`read_size(path)` walks the markers to the frame header without
decoding, as PIL's `size` does.

The numpy functions below are the pixel stages written out
(`idct_islow`, `upsample`, `color`, and `pixels`, which chains them over
a decoded stream's coefficients): the tests and chip_smoke.py hold the
native stages to them bit for bit; the entropy decoding is held to PIL
through the whole decoder.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .. import native
from .png import _l_from_rgb

SIGNATURE = b'\xff\xd8\xff'
# frame markers: SOF0-3, 5-7, 9-11, 13-15 (PIL reads the size from any)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}
_STANDALONE = {0x01, 0xD8, 0xD9, *range(0xD0, 0xD8)}


def decode(data: bytes, mode: str) -> np.ndarray:
    """(H, W, 3) uint8 for mode 'RGB', (H, W) uint8 for 'L'."""
    if mode not in ('RGB', 'L'):
        raise ValueError(f"mode must be 'RGB' or 'L', got {mode!r}")
    rgb = native.jpeg_decode(data)
    if mode == 'RGB':
        return rgb
    if native.jpeg_header(data)['components'] == 1:
        return np.ascontiguousarray(rgb[..., 0])
    return _l_from_rgb(rgb)


def read_size(path: str) -> Tuple[int, int]:
    """(height, width) from the frame header, reading the file segment by
    segment up to it."""
    with open(path, 'rb') as f:
        if f.read(2) != b'\xff\xd8':
            raise ValueError(f'{path}: not a JPEG file (no SOI marker)')
        while True:
            b = f.read(1)
            while b and b != b'\xff':       # stray bytes before a marker
                b = f.read(1)
            while b == b'\xff':             # fill bytes
                b = f.read(1)
            if not b:
                raise ValueError(f'{path}: JPEG file ends before its frame '
                                 f'header')
            m = b[0]
            if m in _STANDALONE:
                if m == 0xD9:
                    raise ValueError(f'{path}: JPEG file has no frame header')
                continue
            head = f.read(2)
            if len(head) < 2:
                raise ValueError(f'{path}: JPEG file is truncated')
            length = int.from_bytes(head, 'big')
            if m in _SOF:
                body = f.read(5)
                if len(body) < 5:
                    raise ValueError(f'{path}: JPEG file is truncated')
                return (int.from_bytes(body[1:3], 'big'),
                        int.from_bytes(body[3:5], 'big'))
            f.seek(length - 2, 1)


# ------------------------------------------------ the pixel stages in numpy

_FIX = {'0_298631336': 2446, '0_390180644': 3196, '0_541196100': 4433,
        '0_765366865': 6270, '0_899976223': 7373, '1_175875602': 9633,
        '1_501321110': 12299, '1_847759065': 15137, '1_961570560': 16069,
        '2_053119869': 16819, '2_562915447': 20995, '3_072711026': 25172}


def _limit_table() -> np.ndarray:
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896],
                     [i + 128, 255, 0], i - 896).astype(np.uint8)


_LIMIT = _limit_table()


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s: Sequence[np.ndarray]):
    """jidctint.c's butterfly on the 8 int64 inputs of one axis: the
    outputs before the descale."""
    f = _FIX
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * f['0_541196100']
    t2 = z1 + z3 * -f['1_847759065']
    t3 = z1 + z2 * f['0_765366865']
    t0 = (s[0] + s[4]) << 13
    t1 = (s[0] - s[4]) << 13
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f['1_175875602']
    t0 = t0 * f['0_298631336']
    t1 = t1 * f['2_053119869']
    t2 = t2 * f['3_072711026']
    t3 = t3 * f['1_501321110']
    z1 = z1 * -f['0_899976223']
    z2 = z2 * -f['2_562915447']
    z3 = z3 * -f['1_961570560'] + z5
    z4 = z4 * -f['0_390180644'] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [t10 + t3, t11 + t2, t12 + t1, t13 + t0,
            t13 - t0, t12 - t1, t11 - t2, t10 - t3]


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(bh*8, bw*8) uint8 of (bh, bw, 64) coefficient blocks in natural
    order, dequantized by `qt` (64, natural order) and inverse-transformed
    as jidctint.c does. Its shortcuts for rows and columns of zero AC
    terms give the full butterfly's values, so none is taken here."""
    bh, bw = coef.shape[:2]
    x = coef.reshape(bh, bw, 8, 8).astype(np.int64) \
        * np.asarray(qt, np.int64).reshape(8, 8)
    # pass 1 down the columns: 2**PASS1_BITS up, into int workspace
    cols = _idct_1d([x[:, :, r, :] for r in range(8)])
    ws = np.stack([_descale(v, 11) for v in cols], axis=2
                  ).astype(np.int32).astype(np.int64)
    # pass 2 along the rows, then the range limit
    rows = _idct_1d([ws[:, :, :, c] for c in range(8)])
    out = np.stack([_LIMIT[_descale(v, 18) & 1023] for v in rows], axis=3)
    return out.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def upsample(plane: np.ndarray, dh: int, dw: int, hr: int, vr: int,
             oh: int, ow: int) -> np.ndarray:
    """The (oh, ow) top-left of the (dh, dw) top-left of `plane` upsampled
    by (hr, vr) in {1, 2}^2 as jdsample.c does: h2v1 and h2v2 triangle
    filters when dw > 2 (the box filter otherwise), h1v2 always; edges
    replicated at (dh, dw)."""
    p = plane[:dh, :dw].astype(np.int32)
    if hr == 1 and vr == 1:
        return np.ascontiguousarray(plane[:oh, :ow])
    if hr == 2 and dw <= 2:
        return np.repeat(np.repeat(p, vr, 0), 2, 1)[:oh, :ow].astype(np.uint8)
    if vr == 2:
        up = np.concatenate([p[:1], p[:-1]])           # row above, clamped
        down = np.concatenate([p[1:], p[-1:]])         # row below, clamped
        if hr == 1:
            out = np.empty((2 * dh, dw), np.int32)
            out[0::2] = (3 * p + up + 1) >> 2
            out[1::2] = (3 * p + down + 2) >> 2
            return out[:oh, :ow].astype(np.uint8)
        sums = np.empty((2 * dh, dw), np.int32)
        sums[0::2] = 3 * p + up
        sums[1::2] = 3 * p + down
        rounding = (8, 7)
        shift = 4
    else:
        sums = p
        rounding = (1, 2)
        shift = 2
    left = np.concatenate([sums[:, :1], sums[:, :-1]], axis=1)
    right = np.concatenate([sums[:, 1:], sums[:, -1:]], axis=1)
    out = np.empty((sums.shape[0], 2 * dw), np.int32)
    out[:, 0::2] = (3 * sums + left + rounding[0]) >> shift
    out[:, 1::2] = (3 * sums + right + rounding[1]) >> shift
    return out[:oh, :ow].astype(np.uint8)


def _ycc_tables():
    fix = lambda v: int(v * 65536 + 0.5)              # noqa: E731
    x = np.arange(256, dtype=np.int64) - 128
    return ((fix(1.40200) * x + 32768) >> 16,
            (fix(1.77200) * x + 32768) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + 32768)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def color(planes: Sequence[np.ndarray], space: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB of one gray plane, or of three planes in colour
    space `space` (1: YCbCr through jdcolor.c's tables, 2: RGB)."""
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if space == 2:
        return np.stack(planes, axis=2).astype(np.uint8)
    y = planes[0].astype(np.int64)
    cb, cr = planes[1], planes[2]
    rgb = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                    y + _CB_B[cb]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def pixels(coefficients: Dict, height: int, width: int,
           factors: Sequence[Tuple[int, int]]) -> np.ndarray:
    """RGB from a decoded stream's coefficients (`native.jpeg_decode(...,
    coefficients=True)`), through the numpy stages alone."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    planes = []
    for coef, qt, (fh, fv) in zip(coefficients['coef'], coefficients['qt'],
                                  factors):
        dw = -(-width * fh // hmax)
        dh = -(-height * fv // vmax)
        hr, vr = (1, 1) if len(factors) == 1 else (hmax // fh, vmax // fv)
        planes.append(upsample(idct_islow(coef, qt), dh, dw, hr, vr,
                               height, width))
    return color(planes, coefficients['space'])
