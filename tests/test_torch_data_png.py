"""The port's PNG decoder (rtseg_tpu_torch/data/png.py) against PIL:
`png.read(path, mode)` equals `np.asarray(Image.open(path).convert(mode))`
bit for bit for 'RGB' and 'L', on files PIL writes (each colour type,
palette depths 1/2/4/8 with and without tRNS, gray and RGB with tRNS) and
on files the port's encoder writes (each filter type and a cycle of all
five, IDAT split across chunks), at odd widths, through the native
unfilter and through the numpy one. Interlaced and 16-bit files raise."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from rtseg_tpu_torch import native
from rtseg_tpu_torch.data import png

WIDTHS = (1, 7, 33)


def _pil(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format='PNG', **kw)
    return buf.getvalue()


def _pil_files(w: int):
    rng = np.random.default_rng(w)
    rgb = rng.integers(0, 256, (5, w, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (5, w), dtype=np.uint8)
    files = {
        'L': _pil(Image.fromarray(gray)),
        'RGB': _pil(Image.fromarray(rgb)),
        'LA': _pil(Image.fromarray(np.dstack([gray, gray[::-1]]), 'LA')),
        'RGBA': _pil(Image.fromarray(np.dstack([rgb, gray]), 'RGBA')),
        'L+tRNS': _pil(Image.fromarray(gray), transparency=3),
        'RGB+tRNS': _pil(Image.fromarray(rgb), transparency=(1, 2, 3)),
    }
    for bits in (1, 2, 4, 8):
        n = 1 << bits
        im = Image.fromarray(rng.integers(0, n, (5, w), dtype=np.uint8), 'P')
        im.putpalette(rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes())
        files[f'P{bits}'] = _pil(im, bits=bits)
        files[f'P{bits}+tRNS'] = _pil(im, bits=bits, transparency=1)
    return files


def _encoded_files(w: int):
    rng = np.random.default_rng(100 + w)
    rgb = rng.integers(0, 256, (9, w, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (9, w), dtype=np.uint8)
    files = {}
    for name, filters in [(f'filter {k}', (k,)) for k in range(5)] + [
            ('all filters', (0, 1, 2, 3, 4))]:
        files[f'RGB {name}'] = png.encode(rgb, filters, idat_chunks=3)
        files[f'L {name}'] = png.encode(gray, filters, idat_chunks=2)
    return files


CASES = [(w, kind, name) for w in WIDTHS
         for kind, make in (('pil', _pil_files), ('encoder', _encoded_files))
         for name in make(w)]


@pytest.fixture(scope='module')
def files():
    return {(w, kind): (_pil_files if kind == 'pil' else _encoded_files)(w)
            for w in WIDTHS for kind in ('pil', 'encoder')}


@pytest.mark.parametrize('w,kind,name', CASES)
@pytest.mark.parametrize('mode', ['RGB', 'L'])
def test_decode_equals_pil(files, w, kind, name, mode, tmp_path):
    data = files[(w, kind)][name]
    path = tmp_path / 'x.png'
    path.write_bytes(data)
    want = np.asarray(Image.open(path).convert(mode))
    got = png.read(str(path), mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('w', WIDTHS)
def test_numpy_unfilter_equals_pil(files, w, monkeypatch):
    """The decoder without the native library (its reference path)."""
    monkeypatch.setattr(native, 'png_unfilter', lambda *a: None)
    for name, data in {**files[(w, 'encoder')], **files[(w, 'pil')]}.items():
        for mode in ('RGB', 'L'):
            want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
            np.testing.assert_array_equal(png.decode(data, mode), want,
                                          err_msg=name)


def test_encoder_writes_the_filter_types_asked_for():
    img = np.random.default_rng(0).integers(0, 256, (10, 6, 3), np.uint8)
    data = png.encode(img, (0, 1, 2, 3, 4), idat_chunks=4)
    idat = b''.join(body for kind, body in png._chunks(data)
                    if kind == b'IDAT')
    assert sum(kind == b'IDAT' for kind, _ in png._chunks(data)) == 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(10, -1)
    assert raw[:, 0].tolist() == [0, 1, 2, 3, 4] * 2


def _with_header(data: bytes, **changes) -> bytes:
    """`data` with IHDR fields replaced (and its CRC made anew)."""
    body = bytearray(data[16:29])
    for field, value in changes.items():
        body[{'depth': 8, 'interlace': 12}[field]] = value
    chunk = b'IHDR' + bytes(body)
    return (data[:8] + struct.pack('>I', 13) + chunk
            + struct.pack('>I', zlib.crc32(chunk)) + data[33:])


def test_interlaced_and_16_bit_files_raise():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match='interlaced'):
        png.decode(_with_header(png.encode(img), interlace=1), 'RGB')
    deep = _pil(Image.fromarray(np.arange(16, dtype=np.uint16).reshape(4, 4)
                                * 4000))
    assert Image.open(io.BytesIO(deep)).mode.startswith('I')
    with pytest.raises(ValueError, match='16-bit'):
        png.decode(deep, 'L')
    with pytest.raises(ValueError, match='signature'):
        png.decode(b'\xff\xd8\xff\xe0' + bytes(20), 'RGB')
    broken = bytearray(png.encode(img))
    broken[40] ^= 1
    with pytest.raises(ValueError, match='CRC'):
        png.decode(bytes(broken), 'RGB')
