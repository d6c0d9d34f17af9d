"""The port's native host library (rtseg_tpu_torch/native) against its
numpy paths and the JAX package's native library, bit for bit:
normalize_hwc and hflip_mask (as tests/test_native.py holds the JAX
package's), the PNG row unfilter on every filter type, and the uint8
bilinear and nearest resizes."""

import numpy as np
import pytest

from rtseg_tpu import native as jnative
from rtseg_tpu_torch import native
from rtseg_tpu_torch.data import png
from rtseg_tpu_torch.data import transforms as T

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
COEFFS = {'imagenet': ((1.0 / (255.0 * STD)).astype(np.float32),
                       (-MEAN / STD).astype(np.float32)),
          'identity': (np.full(3, 1 / 255, np.float32),
                       np.zeros(3, np.float32))}


def test_native_builds_and_counts_its_calls():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    native.reset_counts()
    native.hflip_mask(np.zeros((2, 3), np.int32))
    assert native.counts() == {'hflip_mask': 1}


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('hflip', [False, True])
@pytest.mark.parametrize('coeffs', sorted(COEFFS))
def test_normalize_hwc_matches_numpy_and_the_jax_library(dtype, hflip,
                                                         coeffs):
    rng = np.random.default_rng(0)
    if dtype == np.uint8:
        img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    else:
        img = (rng.random((37, 53, 3)) * 255).astype(np.float32)
    scale, bias = COEFFS[coeffs]
    out = native.normalize_hwc(img, scale, bias, hflip=hflip)
    want = (img[:, ::-1] if hflip else img).astype(np.float32)
    want = want * scale + bias                 # two roundings, as numpy
    assert out.dtype == np.float32 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        out, jnative.normalize_hwc(img, scale, bias, hflip=hflip))


def test_normalize_and_flip_refuse_other_layouts():
    scale, bias = COEFFS['identity']
    assert native.normalize_hwc(np.zeros((8, 8, 3), np.uint8)[:, ::-1],
                                scale, bias) is None
    assert native.normalize_hwc(np.zeros((8, 8, 3), np.float64),
                                scale, bias) is None
    assert native.hflip_mask(np.zeros((3, 4), np.int64)) is None
    m = np.arange(12, dtype=np.int32).reshape(3, 4)
    np.testing.assert_array_equal(native.hflip_mask(m), m[:, ::-1])


def _filtered(rng, h, rowbytes, kinds):
    rows = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    rows[:, 0] = [kinds[y % len(kinds)] for y in range(h)]
    return rows.reshape(-1)


@pytest.mark.parametrize('bpp,rowbytes', [(1, 1), (1, 13), (3, 3 * 17),
                                          (4, 4 * 9), (2, 2 * 5)])
@pytest.mark.parametrize('kinds', [(0,), (1,), (2,), (3,), (4,),
                                   (0, 1, 2, 3, 4), (4, 3, 2, 1, 0)])
def test_png_unfilter_matches_numpy(bpp, rowbytes, kinds):
    rng = np.random.default_rng(bpp * 100 + rowbytes)
    data = _filtered(rng, 11, rowbytes, kinds)
    got = native.png_unfilter(data, 11, rowbytes, bpp)
    np.testing.assert_array_equal(
        got, png.unfilter_numpy(data, 11, rowbytes, bpp))


def test_png_unfilter_rejects_a_bad_filter_type():
    data = _filtered(np.random.default_rng(0), 4, 6, (0,))
    data[2 * 7] = 5
    for fn in (native.png_unfilter, png.unfilter_numpy):
        with pytest.raises(ValueError, match='row 2: filter type 5'):
            fn(data, 4, 6, 3)


@pytest.mark.parametrize('shape', [(37, 53, 3), (5, 3, 3), (64, 128, 3),
                                   (9, 11, 1), (7, 6, 4)])
@pytest.mark.parametrize('factor', [0.25, 0.5, 0.77, 1.0, 1.5, 2.0, 3.1])
def test_resize_linear_matches_numpy(shape, factor):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    h, w = shape[:2]
    nh, nw = max(1, int(h * factor)), max(1, int(w * factor))
    tables = T.linear_tables(h, w, nh, nw)
    np.testing.assert_array_equal(
        native.resize_linear_u8(img, nh, nw, tables),
        T.resize_linear_numpy(img, nh, nw, tables))


@pytest.mark.parametrize('dtype', [np.uint8, np.int32])
@pytest.mark.parametrize('factor', [0.3, 0.5, 1.0, 1.7, 2.0])
def test_resize_nearest_matches_numpy(dtype, factor):
    rng = np.random.default_rng(2)
    for shape in ((37, 53), (37, 53, 3)):
        a = rng.integers(0, 200, shape).astype(dtype)
        nh, nw = int(37 * factor), int(53 * factor)
        sy, sx = T.nearest_tables(37, 53, nh, nw)
        np.testing.assert_array_equal(native.resize_nearest(a, sy, sx),
                                      a[sy][:, sx])
