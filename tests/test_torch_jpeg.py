"""The port's JPEG decoder (rtseg_tpu_torch/native/jpeg.c through
rtseg_tpu_torch/data/jpeg.py) against PIL 12.1's
`Image.open(f).convert('RGB')` on libjpeg-turbo, bit for bit:

* images made from a numpy seed and encoded by PIL over its encoder's
  options (subsampling 4:4:4, 4:2:2, 4:2:0, progressive, optimized
  tables, restart markers by blocks and by rows, gray, RGB-coded, 16-bit
  quantization tables, qualities) at widths 1, 7, 17 and 1023 and heights
  1, 9 and 33, where the fancy upsampling's edges live;
* every committed fixture of tests/data/jpeg/, whose digests must still
  be PIL's;
* the numpy pixel stages (dequantize + ISLOW IDCT, upsampling, colour)
  against the C stages on random coefficient blocks and planes, and the
  numpy chain over a decoded stream's coefficients against the decode;
* truncated data raises ValueError, each refused frame type
  NotImplementedError; `read_size` equals PIL's `size`; mode 'L' equals
  PIL's convert('L'); a decode without the native library raises.
"""

import hashlib
import io
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rtseg_tpu_torch import native
from rtseg_tpu_torch.data import jpeg

FIXTURES = Path(__file__).parent / 'data' / 'jpeg'
DIGESTS = json.loads((FIXTURES / 'digests.json').read_text())


def encode(array: np.ndarray, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, 'JPEG', **opts)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))


def scene(seed: int, h: int, w: int, gray: bool = False) -> np.ndarray:
    """Smooth bands plus noise: every scan and every coefficient band of
    a small image carries data."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    a = 128 + 100 * np.sin(9 * x + 4 * y + np.arange(3)) \
        + rng.normal(0, 25, (h, w, 3))
    a = np.clip(a, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(a[..., 0]) if gray else a


OPTIONS = {
    'baseline_420': dict(),
    '444': dict(subsampling=0),
    '422': dict(subsampling=1),
    'progressive_420': dict(progressive=True),
    'progressive_444': dict(progressive=True, subsampling=0),
    'progressive_422_q40': dict(progressive=True, subsampling=1,
                                quality=40),
    'optimize_q95': dict(optimize=True, quality=95),
    'restart_blocks': dict(restart_marker_blocks=2),
    'restart_rows_progressive': dict(restart_marker_rows=1,
                                     progressive=True),
    'rgb_coded': dict(keep_rgb=True),
    'q100_444': dict(quality=100, subsampling=0),
    'sof1_16bit': dict(qtables=[[300] * 64, [257] * 64]),
}
SIZES = [(1, 1), (1, 7), (9, 17), (33, 1023), (16, 16), (33, 7), (9, 1)]


@pytest.mark.parametrize('option', sorted(OPTIONS))
@pytest.mark.parametrize('gray', [False, True], ids=['colour', 'gray'])
def test_decode_equals_pil_over_the_option_grid(option, gray):
    for i, (h, w) in enumerate(SIZES):
        data = encode(scene(i, h, w, gray), **OPTIONS[option])
        want = pil_rgb(data)
        got = jpeg.decode(data, 'RGB')
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), (option, gray, h, w)


@pytest.mark.parametrize('h,w', [(1, 1023), (1024, 33), (100, 3), (3, 100),
                                 (2, 2), (17, 1)])
@pytest.mark.parametrize('sub', [0, 1, 2])
def test_decode_of_noise_at_the_edges_equals_pil(h, w, sub):
    """Uniform noise (large coefficients, the range limit's clamps) at
    shapes whose chroma width or height is 1 or 2 (the box filter) or odd."""
    rng = np.random.default_rng(h * 7 + w + sub)
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for opts in (dict(subsampling=sub, quality=100),
                 dict(subsampling=sub, quality=10, progressive=True)):
        data = encode(a, **opts)
        assert np.array_equal(jpeg.decode(data, 'RGB'), pil_rgb(data))


@pytest.mark.parametrize('name', sorted(DIGESTS))
def test_fixture_decodes_to_its_pil_digest(name):
    data = (FIXTURES / name).read_bytes()
    want = DIGESTS[name]
    pil = pil_rgb(data)
    assert list(pil.shape) == want['shape']
    assert hashlib.sha256(pil.tobytes()).hexdigest() == want['sha256']
    got = jpeg.decode(data, 'RGB')
    assert hashlib.sha256(got.tobytes()).hexdigest() == want['sha256']
    assert jpeg.read_size(str(FIXTURES / name)) == \
        Image.open(FIXTURES / name).size[::-1]


def test_fixtures_are_small():
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1.5e6


@pytest.mark.parametrize('name', sorted(DIGESTS))
def test_numpy_chain_equals_the_decode(name):
    data = (FIXTURES / name).read_bytes()
    rgb, co = native.jpeg_decode(data, coefficients=True)
    head = native.jpeg_header(data)
    got = jpeg.pixels(co, head['height'], head['width'], head['factors'])
    assert np.array_equal(got, rgb)


@pytest.mark.parametrize('scale', [1, 8, 64, 1024])
def test_idct_stage_equals_numpy(scale):
    """Random blocks, zero columns and rows (the C shortcuts) included,
    and values large enough to wrap libjpeg's range limit."""
    rng = np.random.default_rng(scale)
    coef = rng.integers(-scale, scale + 1, (6, 5, 64)).astype(np.int16)
    coef[0, :, 8:] = 0                    # DC-only blocks
    coef[1, :, rng.random(64) < 0.7] = 0  # sparse blocks
    qt = rng.integers(1, 256, 64).astype(np.uint16)
    got = native.jpeg_idct(coef, qt)
    assert got.shape == (48, 40)
    assert np.array_equal(got, jpeg.idct_islow(coef, qt))


@pytest.mark.parametrize('hr,vr', [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize('dh,dw', [(1, 1), (2, 2), (3, 3), (5, 8), (9, 17)])
def test_upsample_stage_equals_numpy(hr, vr, dh, dw):
    rng = np.random.default_rng(dh * 31 + dw)
    plane = rng.integers(0, 256, (dh + 3, dw + 5), dtype=np.uint8)
    for oh, ow in ((dh * vr, dw * hr), (max(1, dh * vr - 1),
                                        max(1, dw * hr - 1))):
        got = native.jpeg_upsample(plane, dh, dw, hr, vr, oh, ow)
        assert np.array_equal(got, jpeg.upsample(plane, dh, dw, hr, vr, oh,
                                                 ow)), (oh, ow)


@pytest.mark.parametrize('space', [1, 2])
def test_color_stage_equals_numpy(space):
    rng = np.random.default_rng(space)
    planes = [rng.integers(0, 256, (17, 23), dtype=np.uint8)
              for _ in range(3)]
    assert np.array_equal(native.jpeg_color(planes, space),
                          jpeg.color(planes, space))
    assert np.array_equal(native.jpeg_color(planes[:1], 0),
                          jpeg.color(planes[:1], 0))


@pytest.mark.parametrize('gray', [False, True])
def test_mode_l_equals_pil(gray):
    data = encode(scene(3, 21, 30, gray), quality=85)
    want = np.asarray(Image.open(io.BytesIO(data)).convert('L'))
    assert np.array_equal(jpeg.decode(data, 'L'), want)


@pytest.mark.parametrize('progressive', [False, True])
def test_truncated_data_raises(progressive):
    data = encode(scene(4, 40, 48), progressive=progressive)
    for cut in (3, 40, len(data) // 3, len(data) // 2, len(data) - 2):
        with pytest.raises(ValueError, match='truncated|corrupt'):
            jpeg.decode(data[:cut], 'RGB')
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data[:cut])).convert('RGB')


def test_corrupt_data_raises():
    data = bytearray(encode(scene(5, 32, 32), restart_marker_blocks=1))
    at = data.index(b'\xff\xd0')
    data[at + 1] = 0xD3                      # RST out of sequence
    with pytest.raises(ValueError, match='restart marker'):
        jpeg.decode(bytes(data), 'RGB')
    with pytest.raises(ValueError, match='no SOI'):
        jpeg.decode(b'\x00' * 20, 'RGB')


def _with_sof(data: bytes, marker: int) -> bytes:
    at = data.index(b'\xff\xc0')
    return data[:at + 1] + bytes([marker]) + data[at + 2:]


@pytest.mark.parametrize('marker', [0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                                    0xCB, 0xCD, 0xCE, 0xCF])
def test_refused_frame_types_raise_not_implemented(marker):
    data = _with_sof(encode(scene(6, 16, 16)), marker)
    with pytest.raises(NotImplementedError, match='SOF'):
        jpeg.decode(data, 'RGB')


def test_refused_samples_components_and_factors_raise():
    base = encode(scene(7, 16, 16))
    sof = base.index(b'\xff\xc0')
    twelve = bytearray(base)
    twelve[sof + 4] = 12                     # sample precision
    with pytest.raises(NotImplementedError, match='12 bits'):
        jpeg.decode(bytes(twelve), 'RGB')
    buf = io.BytesIO()
    Image.fromarray(scene(8, 16, 16)).convert('CMYK').save(buf, 'JPEG')
    with pytest.raises(NotImplementedError, match='4 components'):
        jpeg.decode(buf.getvalue(), 'RGB')
    four = bytearray(base)
    four[sof + 11] = 0x41                    # luma 4x1 (4:1:1)
    with pytest.raises(NotImplementedError, match='sampling factors'):
        jpeg.decode(bytes(four), 'RGB')
    with pytest.raises(NotImplementedError, match='neither a PNG nor a JPEG'):
        from rtseg_tpu_torch.data import image
        image.decode(b'GIF89a', 'RGB')


def test_read_size_equals_pil_past_app_segments(tmp_path):
    img = Image.fromarray(scene(9, 37, 53))
    exif = Image.Exif()
    exif[0x010E] = 'a description ' * 40
    path = tmp_path / 'with_app.jpg'
    img.save(path, 'JPEG', exif=exif.tobytes(), comment=b'c' * 3000,
             icc_profile=b'\0' * 70000)
    assert jpeg.read_size(str(path)) == (37, 53)
    assert Image.open(path).size == (53, 37)
    assert np.array_equal(jpeg.decode(path.read_bytes(), 'RGB'),
                          pil_rgb(path.read_bytes()))


def test_threads_decode_the_same():
    datas = [encode(scene(i, 64, 96), progressive=i % 2 == 1)
             for i in range(8)]
    want = [pil_rgb(d) for d in datas]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda d: jpeg.decode(d, 'RGB'), datas * 2))
    for i, g in enumerate(got):
        assert np.array_equal(g, want[i % 8])


def test_without_the_native_library_a_decode_raises(monkeypatch):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_tried', True)
    monkeypatch.setattr(native, '_error', 'cc exited 1: no compiler')
    with pytest.raises(RuntimeError, match='native code only.*no compiler'):
        jpeg.decode(encode(scene(1, 8, 8)), 'RGB')
