"""K1's host-side plan (ops/fused_head.py::head_plan) against the dense
interpolation operators and the JAX package.

The CUDA kernel runs only on the card; the plan it is launched with is
built here, on the host, and is where a band or halo error would hide. The
tests hold it to `_interp_matrix`: every output row and column covered
once, each band's rows on one pair of input rows, each group's rows and
each tile's taps inside the window the block loads. `_emulate` then runs
the plan the way the kernel does (window copy, W-lerp of the rows, one lerp
per row and class, lowest-index argmax), in numpy with indices checked, and
the result is held to the JAX package's `resize_argmax` and the port's
plain version.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu.ops.fused_head import resize_argmax as j_resize_argmax

from rtseg_tpu_torch.ops import fused_head as fh
from rtseg_tpu_torch.ops.resize import _interp_matrix

# (h, w, H, W, align_corners): the slice's shape, downsampling, odd sizes,
# h = 1, H = 1, W = 2050, tiles that do not divide W, windows wider than a
# tile's columns
SIZES = [
    (128, 256, 1024, 2048, True),
    (128, 256, 64, 100, True),
    (10, 13, 37, 53, True),
    (10, 13, 37, 53, False),
    (32, 64, 256, 512, False),
    (1, 7, 9, 300, True),
    (8, 16, 1, 40, True),
    (16, 256, 40, 2050, True),
    (5, 300, 16, 1000, False),
    (200, 2048, 30, 16, True),
]


def _plan(sizes, C=19):
    h, w, H, W, ac = sizes
    return fh.head_plan(h, w, H, W, C, ac)


@pytest.mark.parametrize('sizes', SIZES)
def test_plan_covers_every_row_and_column_once(sizes):
    h, w, H, W, ac = sizes
    p = _plan(sizes)
    start = p.band_start
    assert start[0] == 0 and start[-1] == H
    assert (np.diff(start) >= 1).all()
    assert (np.diff(start) <= fh.MAX_BAND_ROWS).all()
    rows = np.concatenate([np.arange(start[k], start[k + 1])
                           for k in range(p.nbands)])
    np.testing.assert_array_equal(rows, np.arange(H))
    groups = p.group_start
    assert groups[0] == 0 and groups[-1] == p.nbands
    assert (np.diff(groups) >= 1).all()
    assert (np.diff(groups) <= fh.GROUP_BANDS).all()
    assert p.ntiles == -(-W // p.tile_w)
    cols = np.concatenate([np.arange(t * p.tile_w,
                                     min((t + 1) * p.tile_w, W))
                           for t in range(p.ntiles)])
    np.testing.assert_array_equal(cols, np.arange(W))


@pytest.mark.parametrize('sizes', SIZES)
def test_band_rows_share_their_pair_and_rebuild_the_operator(sizes):
    h, w, H, W, ac = sizes
    p = _plan(sizes)
    m = _interp_matrix(h, H, ac)
    for k in range(p.nbands):
        lo, hi = int(p.band_lo[k]), int(p.band_hi[k])
        assert 0 <= lo <= hi <= min(lo + 1, h - 1)
        for y in range(p.band_start[k], p.band_start[k + 1]):
            assert set(np.flatnonzero(m[y])) <= {lo, hi}
            a = p.row_a[y]
            assert 0.0 <= a <= 1.0
            dense = np.zeros(h, np.float32)
            dense[lo] += np.float32(1) - a
            dense[hi] += a
            # (1 - a) and the operator's own lo weight may round apart by
            # one float32 step
            np.testing.assert_allclose(dense, m[y], rtol=0, atol=2 ** -23)


@pytest.mark.parametrize('sizes', SIZES)
def test_group_rows_lie_in_the_window_the_block_loads(sizes):
    p = _plan(sizes)
    for g in range(p.ngroups):
        k0, k1 = p.group_start[g], p.group_start[g + 1]
        r0 = p.band_lo[k0]
        rows = p.band_hi[k1 - 1] - r0 + 1
        assert 1 <= rows <= p.group_rows
        assert (p.band_lo[k0:k1] >= r0).all()
        assert (p.band_hi[k0:k1] < r0 + rows).all()
        # bands in order: each band's rows at or after the previous band's
        assert (np.diff(p.band_lo[k0:k1]) >= 0).all()
    assert p.smem_bytes <= fh.SMEM_LIMIT


@pytest.mark.parametrize('sizes', SIZES)
def test_tile_taps_lie_in_the_window_the_block_loads(sizes):
    h, w, H, W, ac = sizes
    p = _plan(sizes)
    lo, hi, wlo, whi = fh.interp_taps(w, W, ac)
    for got, want in ((p.col_lo, lo), (p.col_hi, hi), (p.col_wlo, wlo),
                      (p.col_whi, whi)):
        np.testing.assert_array_equal(got, want)
    assert p.tile_nw.max() == p.win
    assert p.smem_bytes <= fh.SMEM_LIMIT
    for t in range(p.ntiles):
        ws, nw = int(p.tile_ws[t]), int(p.tile_nw[t])
        assert 0 <= ws and 1 <= nw and ws + nw <= w
        x = np.arange(t * p.tile_w, min((t + 1) * p.tile_w, W))
        assert (p.col_lo[x] >= ws).all() and (p.col_hi[x] < ws + nw).all()


def test_plan_packs_in_the_kernels_order():
    p = _plan(SIZES[2], C=6)
    ints, floats = p.ints(), p.floats()
    nb, ng, nt = p.nbands, p.ngroups, p.ntiles
    W, H = len(p.col_lo), len(p.row_a)
    assert ints.dtype == np.int32 and floats.dtype == np.float32
    assert len(ints) == (nb + 1) + 2 * nb + (ng + 1) + 2 * W + 2 * nt
    assert len(floats) == H + 2 * W
    parts = np.split(ints, np.cumsum([nb + 1, nb, nb, ng + 1, W, W, nt]))
    for got, want in zip(parts, (p.band_start, p.band_lo, p.band_hi,
                                 p.group_start, p.col_lo, p.col_hi,
                                 p.tile_ws, p.tile_nw)):
        np.testing.assert_array_equal(got, want)
    parts = np.split(floats, np.cumsum([H, W]))
    for got, want in zip(parts, (p.row_a, p.col_wlo, p.col_whi)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('sizes,C', [(SIZES[0], 19), (SIZES[0], 32),
                                     (SIZES[-1], 19), (SIZES[-1], 32),
                                     (SIZES[7], 32)])
def test_groups_then_tiles_shrink_until_the_window_fits(sizes, C):
    p = _plan(sizes, C)
    assert p.smem_bytes <= fh.SMEM_LIMIT
    assert p.threads == max(p.tile_w, 32)
    size = int(np.diff(p.group_start).max())
    if p.tile_w < fh.TILE_W:
        # tiles shrink only once groups are down to one band, and only
        # while the window does not fit
        assert size == 1
        _, _, wider = fh._tiles(p.col_lo, p.col_hi, 2 * p.tile_w)
        assert fh._smem(p.group_rows, wider, C) > fh.SMEM_LIMIT
    elif size < fh.GROUP_BANDS:
        _, rows = fh._groups(p.band_lo, p.band_hi, 2 * size)
        assert fh._smem(rows, p.win, C) > fh.SMEM_LIMIT
    if sizes == SIZES[0]:
        assert (size, p.tile_w) == (fh.GROUP_BANDS, fh.TILE_W)
    if sizes == SIZES[-1]:
        assert p.tile_w < fh.TILE_W         # 2048 input columns for 16


@pytest.mark.parametrize('C', [fh.REG_CLASSES + 1, 150, 100000])
def test_classes_above_the_register_path_need_no_window(C):
    p = fh.head_plan(128, 256, 1024, 2048, C)
    assert p.smem_bytes == 0
    assert (p.tile_w, int(np.diff(p.group_start).max())) == \
        (fh.TILE_W, fh.GROUP_BANDS)


@pytest.mark.parametrize('C,nc', [(1, 1), (2, 4), (5, 8), (8, 8), (9, 16),
                                  (19, 19), (20, 24), (25, 32), (32, 32),
                                  (33, 0), (150, 0)])
def test_register_instance_is_the_smallest_bucket_that_takes_C(C, nc):
    p = fh.head_plan(10, 13, 37, 53, C)
    assert p.reg_classes == nc
    assert (p.smem_bytes == 0) == (nc == 0)


def test_every_register_bucket_has_a_kernel_instance():
    src = (Path(fh.__file__).parent / 'csrc' / 'fused_head.cu').read_text()
    cases = sorted(int(n) for n in re.findall(
        r'case (\d+): return launch<T, \1>', src))
    assert cases == [0, *fh.REG_BUCKETS]
    assert fh.REG_CLASSES == max(fh.REG_BUCKETS)


def _emulate(p, x):
    """The kernel's arithmetic on plan `p`, in numpy float32: a (group,
    tile) reads only its window, and every index into it is checked. The
    window holds the register bucket's classes, those past C NaN, and the
    argmax is the kernel's: a strict '>' in class order, with a max that
    passes over NaN."""
    B, h, w, C = x.shape
    x = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, max(p.reg_classes - C, 0))),
               constant_values=np.nan)
    H, W = len(p.row_a), len(p.col_lo)
    out = np.full((B, H, W), -1, np.int32)
    for t in range(p.ntiles):
        cols = np.arange(t * p.tile_w, min((t + 1) * p.tile_w, W))
        ws, nw = p.tile_ws[t], p.tile_nw[t]
        l, r = p.col_lo[cols] - ws, p.col_hi[cols] - ws
        assert (l >= 0).all() and (r < nw).all()
        wl, wr = p.col_wlo[cols, None], p.col_whi[cols, None]
        for g in range(p.ngroups):
            k0, k1 = p.group_start[g], p.group_start[g + 1]
            r0 = p.band_lo[k0]
            win = x[:, r0:p.band_hi[k1 - 1] + 1, ws:ws + nw]
            for k in range(k0, k1):
                lo, hi = p.band_lo[k] - r0, p.band_hi[k] - r0
                assert 0 <= lo <= hi < win.shape[1]
                u = wr * win[:, lo, r] + wl * win[:, lo, l]
                d = (wr * win[:, hi, r] + wl * win[:, hi, l]) - u
                rows = np.arange(p.band_start[k], p.band_start[k + 1])
                v = u[:, None] + p.row_a[rows, None, None] * d[:, None]
                assert v.dtype == np.float32
                best, idx = v[..., 0], np.zeros(v.shape[:-1], np.int32)
                for c in range(1, v.shape[-1]):
                    with np.errstate(invalid='ignore'):
                        idx = np.where(v[..., c] > best, c, idx)
                    best = np.fmax(best, v[..., c])
                out[:, rows[:, None], cols] = idx
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize('sizes', [s for s in SIZES
                                   if s[2] * s[3] <= 256 * 512])
def test_plan_run_as_the_kernel_runs_matches_jax(sizes):
    h, w, H, W, ac = sizes
    x = np.random.RandomState(7).randn(2, h, w, 6).astype(np.float32)
    got = _emulate(fh.head_plan(h, w, H, W, 6, ac), x)
    want = np.asarray(j_resize_argmax(jnp.asarray(x), (H, W), ac))
    assert float((got != want).mean()) <= 1e-4
    plain = fh._argmax_ref(torch.from_numpy(x), (H, W), ac).numpy()
    assert float((got != plain).mean()) <= 1e-4


def test_plan_run_as_the_kernel_runs_keeps_ties_and_one_class():
    zeros = np.zeros((1, 8, 8, 5), np.float32)
    assert (_emulate(fh.head_plan(8, 8, 64, 128, 5), zeros) == 0).all()
    one = np.random.RandomState(8).randn(1, 10, 13, 1).astype(np.float32)
    assert (_emulate(fh.head_plan(10, 13, 37, 53, 1), one) == 0).all()
