"""Host-side augmentation pipeline (counterpart of
rtseg_tpu/data/transforms.py), numpy and the port's native library.

The same functions and transform classes with the same rng draw order, so
a sample equals the JAX package's bit for bit. The three cv2 calls of the
JAX module are written here, each bit-equal to cv2 on uint8 images:
  * `resize_linear` is cv2.resize's INTER_LINEAR on uint8, which is not a
    float bilinear: 11-bit fixed-point column weights, an int horizontal
    pass, and a vertical pass that rounds as cv2's SIMD code does,
    ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16), then (v + 2) >> 2;
  * `resize_nearest` is INTER_NEAREST, min(floor(x * (1 / (W / w))), w - 1)
    in float64 on each axis;
  * `pad_constant` is copyMakeBorder with BORDER_CONSTANT;
  * `rgb_to_gray` is cvtColor(RGB2GRAY) on float32:
    fma(B, 0.114f, fma(R, 0.299f, G * 0.587f)) with one rounding each,
    except that where a row's width leaves 4-7 columns past its last block
    of 8, the first and third of those take fma(B, 0.114f, fma(G, 0.587f,
    R * 0.299f)): cv2's tail loop.
`resize_nearest_pil` is PIL's Image.resize(NEAREST), which prediction
uses for its blends (an accumulated float64 source position a pixel).
The resizes run their integer work in the native library (native/host.c)
when it is built, held bit-equal to the numpy versions here.

  train (cityscapes): Scale -> RandomScale -> PadIfNeeded(114, mask 0) ->
    RandomCrop -> ColorJitter -> HorizontalFlip(p) -> Normalize(ImageNet)
  val: Scale -> Normalize
  custom adds ResizeToSquare and identity normalization.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_COEF = np.float32(2048)        # cv2's INTER_RESIZE_COEF_SCALE


def _linear_axis(dst: int, src: int):
    """cv2's source index and float32 fraction of each output position."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int32)
    return s, f - s.astype(np.float32)


def linear_tables(h: int, w: int, nh: int, nw: int):
    """int32 (x0, x1, a0, a1, y0, y1, b0, b1): the two source columns and
    rows of each output pixel and their 2048-scaled weights. Columns past
    the border clamp to it with weight 0; rows keep their weights and clamp
    each index (a replicated border)."""
    sx, fx = _linear_axis(nw, w)
    out = (sx < 0) | (sx >= w - 1)
    fx = np.where(out, np.float32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    x1 = np.minimum(sx + 1, w - 1)
    sy, fy = _linear_axis(nh, h)
    y0 = np.clip(sy, 0, h - 1)
    y1 = np.clip(sy + 1, 0, h - 1)

    def weights(f):
        return (np.rint((np.float32(1) - f) * _COEF).astype(np.int32),
                np.rint(f * _COEF).astype(np.int32))
    a0, a1 = weights(fx)
    b0, b1 = weights(fy)
    return (sx.astype(np.int32), x1.astype(np.int32), a0, a1,
            y0.astype(np.int32), y1.astype(np.int32), b0, b1)


def resize_linear_numpy(image: np.ndarray, nh: int, nw: int,
                        tables=None) -> np.ndarray:
    """The reference of resize_linear."""
    h, w = image.shape[:2]
    x0, x1, a0, a1, y0, y1, b0, b1 = tables or linear_tables(h, w, nh, nw)
    x = image.astype(np.int32)
    hor = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    v = (((hor[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((hor[y1] >> 4) * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def resize_linear(image: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR) of an
    (H, W, C) uint8 image."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise TypeError(f'resize_linear takes (H, W, C) uint8, got '
                        f'{image.shape} {image.dtype}')
    tables = linear_tables(image.shape[0], image.shape[1], nh, nw)
    out = native.resize_linear_u8(image, nh, nw, tables)
    return out if out is not None else resize_linear_numpy(image, nh, nw,
                                                           tables)


def nearest_tables(h: int, w: int, nh: int, nw: int):
    def axis(dst, src):
        return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))),
                          src - 1).astype(np.int64)
    return axis(nh, h), axis(nw, w)


def resize_nearest(array: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """cv2.resize(array, (nw, nh), interpolation=cv2.INTER_NEAREST)."""
    sy, sx = nearest_tables(array.shape[0], array.shape[1], nh, nw)
    out = native.resize_nearest(array, sy, sx)
    return out if out is not None else array[sy][:, sx]


def _pil_nearest_axis(dst: int, src: int) -> np.ndarray:
    """PIL's source index of each of `dst` pixels (ImagingScaleAffine):
    the position starts at scale/2 and adds scale = src/dst a pixel, in
    float64, one rounding a step, truncated. The accumulated rounding is
    why it is not floor((x + 0.5) * src / dst) at every ratio."""
    scale = src / dst
    steps = np.full(dst, scale)
    steps[0] = scale * 0.5
    pos = np.add.accumulate(steps)          # sequential, like the C loop
    return np.clip(pos.astype(np.int64), 0, src - 1)


def resize_nearest_pil(array: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """`np.asarray(Image.fromarray(array).resize((nw, nh),
    Image.NEAREST))`, bit for bit, without PIL."""
    h, w = array.shape[:2]
    if (h, w) == (nh, nw):
        return array.copy()
    sy, sx = _pil_nearest_axis(nh, h), _pil_nearest_axis(nw, w)
    out = native.resize_nearest(array, sy, sx)
    return out if out is not None else array[sy][:, sx]


def pad_constant(array: np.ndarray, top: int, bottom: int, left: int,
                 right: int, value) -> np.ndarray:
    """cv2.copyMakeBorder(array, top, bottom, left, right,
    cv2.BORDER_CONSTANT, value=value) of an (H, W) or (H, W, C<=4) array."""
    h, w = array.shape[:2]
    # cv2's Scalar: up to 4 channel values, the missing ones 0
    fill = np.zeros(4, array.dtype)
    given = np.atleast_1d(np.asarray(value, array.dtype))
    fill[:len(given)] = given
    out = np.empty((h + top + bottom, w + left + right) + array.shape[2:],
                   array.dtype)
    out[...] = fill[:array.shape[2]] if array.ndim == 3 else fill[0]
    out[top:top + h, left:left + w] = array
    return out


def _fma32(a: np.ndarray, b: np.float32, c: np.ndarray) -> np.ndarray:
    """float32 fma(a, b, c), rounded once: a*b is exact in float64, the
    float64 sum's rounding error is recovered exactly (TwoSum), and decides
    a float64 sum that falls on a float32 halfway point."""
    p = a.astype(np.float64) * np.float64(b)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    tie = (s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    nudge = tie & (err != 0)
    if nudge.any():
        s = np.where(nudge, np.nextafter(s, np.where(err > 0, np.inf,
                                                     -np.inf)), s)
    return s.astype(np.float32)


_R2Y, _G2Y, _B2Y = np.float32(0.299), np.float32(0.587), np.float32(0.114)


def rgb_to_gray(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) of an (H, W, 3) float32
    image, bit for bit."""
    image = np.asarray(image, np.float32)
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    out = _fma32(b, _B2Y, _fma32(r, _R2Y, g * _G2Y))
    w = image.shape[1]
    if w % 8 >= 4:
        cols = [w - w % 8, w - w % 8 + 2]
        out[:, cols] = _fma32(b[:, cols], _B2Y,
                              _fma32(g[:, cols], _G2Y, r[:, cols] * _R2Y))
    return out


def scale(image, mask, factor: float):
    """transforms.Scale: resize by a fixed factor (bilinear img / nearest mask)."""
    if factor == 1.0:
        return image, mask
    h, w = image.shape[:2]
    nh, nw = int(h * factor), int(w * factor)
    image = resize_linear(image, nw, nh)
    if mask is not None:
        mask = resize_nearest(mask, nw, nh)
    return image, mask


def random_scale(image, mask, scale_limit, rng: np.random.Generator):
    """AT.RandomScale: factor ~ U(1+lo, 1+hi); scalar limit -> (-l, +l)."""
    if np.isscalar(scale_limit):
        lo, hi = -float(scale_limit), float(scale_limit)
    else:
        lo, hi = float(scale_limit[0]), float(scale_limit[1])
    if lo == 0.0 and hi == 0.0:
        return image, mask
    factor = 1.0 + rng.uniform(lo, hi)
    return scale(image, mask, factor)


def pad_if_needed(image, mask, min_h: int, min_w: int,
                  value=(114, 114, 114), mask_value=0):
    """AT.PadIfNeeded: center-pad to at least (min_h, min_w)."""
    h, w = image.shape[:2]
    if h >= min_h and w >= min_w:
        return image, mask
    pt = max(0, (min_h - h) // 2)
    pb = max(0, min_h - h - pt)
    pl = max(0, (min_w - w) // 2)
    pr = max(0, min_w - w - pl)
    image = pad_constant(image, pt, pb, pl, pr, value)
    if mask is not None:
        mask = pad_constant(mask, pt, pb, pl, pr, mask_value)
    return image, mask


def random_crop(image, mask, crop_h: int, crop_w: int,
                rng: np.random.Generator):
    h, w = image.shape[:2]
    top = int(rng.integers(0, h - crop_h + 1)) if h > crop_h else 0
    left = int(rng.integers(0, w - crop_w + 1)) if w > crop_w else 0
    image = image[top:top + crop_h, left:left + crop_w]
    if mask is not None:
        mask = mask[top:top + crop_h, left:left + crop_w]
    return image, mask


def color_jitter(image, brightness: float, contrast: float, saturation: float,
                 rng: np.random.Generator):
    """ColorJitter with uniformly-sampled factors in [max(0,1-x), 1+x],
    applied in randomized order (albumentations/torchvision behavior)."""
    if brightness == 0 and contrast == 0 and saturation == 0:
        return image
    img = image.astype(np.float32)

    def _bright(im):
        if brightness == 0:
            return im
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        return im * f

    def _contrast(im):
        if contrast == 0:
            return im
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        mean = rgb_to_gray(im.astype(np.float32)).mean()
        return im * f + mean * (1 - f)

    def _sat(im):
        if saturation == 0:
            return im
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        gray = rgb_to_gray(im.astype(np.float32))
        return im * f + gray[..., None] * (1 - f)

    fns = [_bright, _contrast, _sat]
    order = rng.permutation(3)
    for i in order:
        img = fns[i](img)
    img = img.astype(np.float32, copy=False)
    return np.clip(img, 0, 255)


def horizontal_flip(image, mask, p: float, rng: np.random.Generator):
    if p > 0 and rng.random() < p:
        image = image[:, ::-1]
        if mask is not None:
            mask = mask[:, ::-1]
    return image, mask


def vertical_flip(image, mask, p: float, rng: np.random.Generator):
    if p > 0 and rng.random() < p:
        image = image[::-1]
        if mask is not None:
            mask = mask[::-1]
    return image, mask


def normalize(image, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """AT.Normalize: (img/255 - mean) / std, float32 HWC, folded to one
    multiply-add."""
    std = np.asarray(std, np.float32)
    scale_ = 1.0 / (255.0 * std)
    bias_ = -np.asarray(mean, np.float32) / std
    out = image.astype(np.float32)
    out *= scale_
    out += bias_
    return out


def _norm_coeffs(identity_norm: bool):
    if identity_norm:
        return (np.full(3, 1.0 / 255.0, np.float32),
                np.zeros(3, np.float32))
    return (np.float32(1.0) / (255.0 * IMAGENET_STD),
            (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32))


def flip_norm_pack(image, mask, do_h: bool, do_v: bool,
                   identity_norm: bool = False):
    """Augmentation tail: (flips) + normalize + contiguous f32 copy, one
    native pass when the library is built (flips and the elementwise
    normalize commute); the numpy path is numerically identical."""
    if do_v:                               # rare path: numpy view + copy
        image = np.ascontiguousarray(image[::-1])
        if mask is not None:
            mask = mask[::-1]
    scale_, bias_ = _norm_coeffs(identity_norm)
    out = None
    if native.available():
        img_n = image if image.flags.c_contiguous \
            else np.ascontiguousarray(image)
        out = native.normalize_hwc(img_n, scale_, bias_, hflip=do_h)
    if out is None:
        if do_h:
            image = image[:, ::-1]
        out = image.astype(np.float32)
        out *= scale_
        out += bias_
        out = np.ascontiguousarray(out)
    if mask is None:
        return out, None
    if do_h:
        flipped = native.hflip_mask(mask) if (
            mask.dtype == np.int32 and mask.flags.c_contiguous) else None
        mask = flipped if flipped is not None else mask[:, ::-1]
    return out, np.ascontiguousarray(mask)


def resize_to_square(image, mask, size: int):
    """Zero-pad to square then resize to (size, size)."""
    h, w = image.shape[:2]
    m = max(h, w)
    hp, vp = (m - w) // 2, (m - h) // 2
    image = np.pad(image, ((vp, vp), (hp, hp), (0, 0)), constant_values=0)
    if mask is not None:
        mask = np.pad(mask, ((vp, vp), (hp, hp)), constant_values=0)
    image = resize_linear(image, size, size)
    if mask is not None:
        mask = resize_nearest(mask, size, size)
    return image, mask


class TrainTransform:
    """The reference train-time stack; `identity_norm` selects the custom
    dataset's Normalize(mean=0, std=1) variant.

    Split into a deterministic ``prefix`` (square resize + fixed scale,
    what the packed cache stores once) and a random ``suffix``
    (random-scale/pad/crop/jitter/flips/normalize, recomputed per epoch),
    with ``__call__ = suffix . prefix``.
    """

    def __init__(self, config, identity_norm: bool = False,
                 square_size: Optional[int] = None):
        self.config = config
        self.identity_norm = identity_norm
        self.square_size = square_size

    @property
    def supports_raw_tail(self) -> bool:
        """Whether ``suffix_raw`` can hand off uint8: color jitter promotes
        to float32, so the uint8 transfer is exact only without it."""
        c = self.config
        return c.brightness == 0 and c.contrast == 0 and c.saturation == 0

    def norm_coeffs(self):
        """(scale, bias) of the normalize tail, which the card's stage
        (ops/augment.py) applies to raw-tail batches."""
        return _norm_coeffs(self.identity_norm)

    def prefix(self, image, mask):
        """Deterministic, rng-free head: cacheable per sample."""
        c = self.config
        if self.square_size:
            image, mask = resize_to_square(image, mask, self.square_size)
        return scale(image, mask, c.scale)

    def _suffix_head(self, image, mask, rng: np.random.Generator):
        """Shared random stage up to (but not including) the flip draws."""
        c = self.config
        image, mask = random_scale(image, mask, c.randscale, rng)
        image, mask = pad_if_needed(image, mask, c.crop_h, c.crop_w)
        image, mask = random_crop(image, mask, c.crop_h, c.crop_w, rng)
        image = color_jitter(image, c.brightness, c.contrast, c.saturation,
                             rng)
        # the draw order of horizontal_flip/vertical_flip; the flips are
        # folded into the fused normalize pass (or left to the card by
        # suffix_raw)
        do_h = c.h_flip > 0 and rng.random() < c.h_flip
        do_v = c.v_flip > 0 and rng.random() < c.v_flip
        return image, mask, do_h, do_v

    def suffix(self, image, mask, rng: np.random.Generator):
        """Random tail incl. the host normalize/flip pack (f32 out)."""
        image, mask, do_h, do_v = self._suffix_head(image, mask, rng)
        return flip_norm_pack(image, mask, do_h, do_v, self.identity_norm)

    def suffix_raw(self, image, mask, rng: np.random.Generator):
        """Random tail without the normalize/flip pack: the uint8 image,
        the unflipped mask and the flip draws, for the card's stage. The
        rng draws of ``suffix``; requires ``supports_raw_tail``."""
        image, mask, do_h, do_v = self._suffix_head(image, mask, rng)
        image = np.ascontiguousarray(image)      # crop yields strided views
        if mask is not None:
            mask = np.ascontiguousarray(mask)
        return image, mask, (do_h, do_v)

    def __call__(self, image, mask, rng: np.random.Generator):
        image, mask = self.prefix(image, mask)
        return self.suffix(image, mask, rng)


class EvalTransform:
    """The reference val/test stack: (square) scale + normalize, with
    TrainTransform's prefix/suffix split (the suffix is rng-free)."""

    def __init__(self, config, identity_norm: bool = False,
                 square_size: Optional[int] = None):
        self.config = config
        self.identity_norm = identity_norm
        self.square_size = square_size

    #: no jitter in the eval stack: the uint8 handoff is always exact
    supports_raw_tail = True

    def norm_coeffs(self):
        return _norm_coeffs(self.identity_norm)

    def prefix(self, image, mask):
        c = self.config
        if self.square_size:
            image, mask = resize_to_square(image, mask, self.square_size)
        return scale(image, mask, c.scale)

    def suffix(self, image, mask, rng=None):
        image, mask = flip_norm_pack(image, mask, False, False,
                                     self.identity_norm)
        return image, mask

    def suffix_raw(self, image, mask, rng=None):
        image = np.ascontiguousarray(image)
        if mask is not None:
            mask = np.ascontiguousarray(mask)
        return image, mask, (False, False)

    def __call__(self, image, mask=None, rng=None):
        image, mask = self.prefix(image, mask)
        image, mask = self.suffix(image, mask, rng)
        if mask is None:
            return image
        return image, mask
