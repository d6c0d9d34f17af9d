"""The port's transforms (rtseg_tpu_torch/data/transforms.py) against cv2
and against the JAX package's transforms, bit for bit.

* `resize_linear` equals cv2.resize INTER_LINEAR on HWC uint8 over a grid
  of down and up factors, the factors random_scale draws from
  randscale (-0.5, 1.0) and resize_to_square's; `resize_nearest` equals
  INTER_NEAREST on HW uint8 and int32; `pad_constant` copyMakeBorder with
  BORDER_CONSTANT; `rgb_to_gray` cvtColor(RGB2GRAY) on float32 at every
  width from 1 to 40 (cv2's tail columns included) and on strided views.
  Each through the native library and through numpy.
* TrainTransform and EvalTransform equal the JAX package's with the same
  rng: the float suffix and suffix_raw, color jitter on and off, ImageNet
  and identity normalization, a square resize and a fixed scale.
"""

from fractions import Fraction

import cv2
import numpy as np
import pytest

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.data import transforms as J
from rtseg_tpu_torch import native
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import transforms as T

SHAPES = ((37, 53), (64, 128), (5, 3), (100, 200))
FACTORS = (0.25, 0.5, 0.6, 0.77, 1.0, 1.37, 1.5, 2.0, 3.0) + tuple(
    1.0 + np.random.default_rng(0).uniform(-0.5, 1.0, 4))


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Each case through the native library and through numpy."""
    if request.param == 'numpy':
        monkeypatch.setattr(native, 'resize_linear_u8', lambda *a: None)
        monkeypatch.setattr(native, 'resize_nearest', lambda *a: None)
    return request.param


@pytest.mark.parametrize('shape', SHAPES)
def test_resize_equals_cv2(shape, path):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    mask = rng.integers(0, 34, shape, dtype=np.uint8)
    for f in FACTORS:
        nh, nw = max(1, int(shape[0] * f)), max(1, int(shape[1] * f))
        np.testing.assert_array_equal(
            T.resize_linear(img, nw, nh),
            cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR),
            err_msg=f'linear {shape} x{f}')
        for m in (mask, mask.astype(np.int32)):
            np.testing.assert_array_equal(
                T.resize_nearest(m, nw, nh),
                cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST),
                err_msg=f'nearest {m.dtype} {shape} x{f}')


def test_scale_and_square_equal_the_jax_package(path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    mask = rng.integers(0, 34, (48, 80), dtype=np.uint8)
    for size in (32, 64, 91):
        for a, b in zip(T.resize_to_square(img, mask, size),
                        J.resize_to_square(img, mask, size)):
            np.testing.assert_array_equal(a, b)
    for limit in ((-0.5, 1.0), 0.3):
        for seed in range(6):
            got = T.random_scale(img, mask, limit,
                                 np.random.default_rng(seed))
            want = J.random_scale(img, mask, limit,
                                  np.random.default_rng(seed))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('args', [(1, 2, 3, 4), (0, 0, 5, 0), (3, 0, 0, 0),
                                  (0, 0, 0, 0)])
def test_pad_equals_copy_make_border(args):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    mask = rng.integers(0, 34, (6, 7), dtype=np.uint8)
    border = cv2.BORDER_CONSTANT
    for a, value in ((img, (114, 114, 114)), (img, 7), (mask, 0),
                     (mask.astype(np.int32), 255)):
        np.testing.assert_array_equal(
            T.pad_constant(a, *args, value),
            cv2.copyMakeBorder(a, *args, border, value=value))


def test_gray_equals_cvtcolor_at_every_width():
    rng = np.random.default_rng(2)
    for w in range(1, 41):
        im = (rng.random((13, w, 3)) * 300).astype(np.float32)
        np.testing.assert_array_equal(
            T.rgb_to_gray(im), cv2.cvtColor(im, cv2.COLOR_RGB2GRAY),
            err_msg=f'width {w}')
    big = (rng.random((257, 391, 3)) * 255).astype(np.float32)
    for im in (big, big[3:200, 5:300]):
        np.testing.assert_array_equal(T.rgb_to_gray(im),
                                      cv2.cvtColor(im, cv2.COLOR_RGB2GRAY))


def test_fma_rounds_once():
    """float32 fma(a, b, c) with one rounding: a float64 sum that lands on
    a float32 halfway point is decided by its rounding error, and random
    operands round to the float32 nearest the exact value."""
    a = np.float32(2.0 ** -24 * (1 + 2.0 ** -15))
    b = np.float32(1 - 2.0 ** -15)
    c = np.float32(1 + 2.0 ** -23)
    # a*b + c lies 2**-54 below the halfway point between c and its
    # successor, and the float64 sum rounds onto that point
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive != c
    assert T._fma32(np.array([a]), b, np.array([c]))[0] == c
    rng = np.random.default_rng(3)
    xs = (rng.random(2000) * 300).astype(np.float32)
    cs = (rng.random(2000) * 300).astype(np.float32)
    k = np.float32(0.587)
    got = T._fma32(xs, k, cs)
    for x, c, g in zip(xs[:300], cs[:300], got[:300]):
        exact = Fraction(float(x)) * Fraction(float(k)) + Fraction(float(c))
        err = abs(Fraction(float(g)) - exact)
        for n in (np.nextafter(g, np.float32(-1e9)),
                  np.nextafter(g, np.float32(1e9))):
            assert err <= abs(Fraction(float(n)) - exact)


def _configs(**kw):
    base = dict(crop_size=40, randscale=(-0.5, 1.0), h_flip=0.5, v_flip=0.3,
                scale=1.0)
    base.update(kw)
    return SegConfig(**base).resolve(), JaxSegConfig(**base).resolve()


CASES = {
    'plain': dict(),
    'jitter': dict(brightness=0.5, contrast=0.5, saturation=0.5),
    'contrast only': dict(contrast=0.4),
    'scale': dict(scale=0.75, crop_size=24),
    'big crop': dict(crop_size=96),
    # 45 columns: cv2's gray tail takes the last 5 of each row
    'odd crop, jitter': dict(crop_h=30, crop_w=45, brightness=0.5,
                             contrast=0.5, saturation=0.5),
}


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('identity', [False, True])
@pytest.mark.parametrize('square', [None, 56])
def test_transforms_equal_the_jax_package(case, identity, square):
    cfg, jcfg = _configs(**CASES[case])
    rng = np.random.default_rng(len(case))
    img = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    mask = rng.integers(0, 34, (45, 70), dtype=np.uint8)
    pairs = [
        (T.TrainTransform(cfg, identity, square),
         J.TrainTransform(jcfg, identity, square)),
        (T.EvalTransform(cfg, identity, square),
         J.EvalTransform(jcfg, identity, square))]
    for ours, theirs in pairs:
        assert ours.supports_raw_tail == theirs.supports_raw_tail
        for a, b in zip(ours.norm_coeffs(), theirs.norm_coeffs()):
            np.testing.assert_array_equal(a, b)
        head = ours.prefix(img, mask)
        for a, b in zip(head, theirs.prefix(img, mask)):
            np.testing.assert_array_equal(a, b)
        tails = ['suffix'] + (['suffix_raw'] if ours.supports_raw_tail
                              else [])
        for tail in tails:
            for seed in range(4):
                got = getattr(ours, tail)(*head, np.random.default_rng(seed))
                want = getattr(theirs, tail)(*head,
                                             np.random.default_rng(seed))
                assert len(got) == len(want)
                for a, b in zip(got[:2], want[:2]):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
                assert tuple(got[2:]) == tuple(want[2:])
        got = ours(img, mask, np.random.default_rng(9))
        want = theirs(img, mask, np.random.default_rng(9))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
