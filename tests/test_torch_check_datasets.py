"""The port's labelme conversion (rtseg_tpu_torch/utils/check_datasets.py)
against the JAX package's (rtseg_tpu/utils/check_datasets.py), which
decodes with PIL and rasterizes with PIL's ImageDraw:

* `rasterize_polygon` bit-equal to Pillow 12.1's
  `ImageDraw.polygon(points, fill=ink)` on random polygons of several
  families: concave and self-intersecting, self-touching (repeated and
  collinear vertices), sub-pixel, out of the image, on half-integers,
  and long thin slivers;
* the whole tree from both converters over the same labelme folder
  (JSONs with JPEG and PNG `imageData`, and with `imagePath` naming a
  JPEG or a PNG beside them; polygons of three labels, other shape types
  and short point lists skipped): the same file names in the same
  split, the same data.yaml text, the same image pixels and the same
  mask pixels.
"""

import base64
import io
import json
import os

import numpy as np
import pytest
from PIL import Image, ImageDraw

from rtseg_tpu.utils.check_datasets import \
    check_semantic_segmentation_datasets as jax_check
from rtseg_tpu_torch.utils.check_datasets import (
    check_semantic_segmentation_datasets, rasterize_polygon)


def pil_fill(points, h, w, ink=7):
    mask = Image.new('L', (w, h), 0)
    ImageDraw.Draw(mask).polygon(points, fill=ink)
    return np.asarray(mask)


def port_fill(points, h, w, ink=7):
    mask = np.zeros((h, w), np.uint8)
    rasterize_polygon(mask, points, ink)
    return mask


def _family(kind, rng, h, w):
    n = int(rng.integers(3, 10))
    if kind == 'float':
        return [(float(rng.uniform(0, w)), float(rng.uniform(0, h)))
                for _ in range(n)]
    if kind == 'integer':
        return [(int(rng.integers(0, w)), int(rng.integers(0, h)))
                for _ in range(n)]
    if kind == 'outside':
        return [(float(rng.uniform(-w, 2 * w)), float(rng.uniform(-h, 2 * h)))
                for _ in range(n)]
    if kind == 'half':
        return [(rng.integers(-1, w + 1) + 0.5 * rng.integers(0, 2),
                 rng.integers(-1, h + 1) + 0.5 * rng.integers(0, 2))
                for _ in range(n)]
    if kind == 'subpixel':
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        return [(cx + rng.uniform(-1.2, 1.2), cy + rng.uniform(-1.2, 1.2))
                for _ in range(n)]
    if kind == 'touching':
        pts = [(int(rng.integers(0, w)), int(rng.integers(0, h)))
               for _ in range(n)]
        k = int(rng.integers(1, n))
        pts.insert(k, pts[k - 1])                         # repeated vertex
        a, b = pts[0], pts[1]
        pts.insert(2, ((a[0] + b[0]) / 2, (a[1] + b[1]) / 2))  # collinear
        pts.append(pts[0])                                 # closed by hand
        return pts
    if kind == 'sliver':
        x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
        x1, y1 = rng.uniform(0, w), rng.uniform(0, h)
        d = rng.uniform(0.1, 2.0)
        return [(x0, y0), (x1, y1), (x1 + d, y1 + d * rng.uniform(-1, 1))]
    if kind == 'concave':
        t = np.sort(rng.uniform(0, 2 * np.pi, n + 3))
        r = rng.uniform(0.2, 1.0, n + 3) * min(h, w) / 2
        return [(float(w / 2 + ri * np.cos(ti)), float(h / 2 + ri * np.sin(ti)))
                for ri, ti in zip(r, t)]
    raise AssertionError(kind)


@pytest.mark.parametrize('kind', ['float', 'integer', 'outside', 'half',
                                  'subpixel', 'touching', 'sliver',
                                  'concave'])
def test_rasterize_equals_pil(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    for _ in range(250):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        pts = _family(kind, rng, h, w)
        np.testing.assert_array_equal(port_fill(pts, h, w),
                                      pil_fill(pts, h, w), str(pts))


def test_rasterize_equals_pil_at_full_size():
    rng = np.random.default_rng(2)
    for _ in range(3):
        pts = _family('concave', rng, 1024, 2048) + \
            _family('outside', rng, 1024, 2048)[:2]
        np.testing.assert_array_equal(port_fill(pts, 1024, 2048, 1),
                                      pil_fill(pts, 1024, 2048, 1))


def _image_bytes(rng, h, w, fmt):
    a = np.clip(rng.normal(128, 60, (h, w, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, fmt, **({'quality': 85}
                                         if fmt == 'JPEG' else {}))
    return buf.getvalue()


def labelme_folder(root, n=25, seed=0):
    """n labelme JSONs in root/labels: imageData JPEG or PNG, or
    imagePath naming a JPEG or PNG file beside the JSON."""
    rng = np.random.default_rng(seed)
    labels = os.path.join(root, 'labels')
    os.makedirs(labels)
    for i in range(n):
        h, w = int(rng.integers(20, 48)), int(rng.integers(20, 64))
        fmt = ('JPEG', 'PNG')[i % 2]
        data = _image_bytes(rng, h, w, fmt)
        shapes = []
        for k in range(int(rng.integers(1, 5))):
            kind = ('float', 'concave', 'outside', 'half')[k % 4]
            shapes.append({'label': ('car', 'road', 'tree')[
                int(rng.integers(0, 3))],
                'points': [list(p) for p in _family(kind, rng, h, w)],
                'shape_type': 'polygon'})
        shapes.append({'label': 'sign', 'points': [[1, 1], [5, 5]],
                       'shape_type': 'rectangle'})
        shapes.append({'label': 'road', 'points': [[1, 1], [5, 5]],
                       'shape_type': 'polygon'})
        record = {'shapes': shapes, 'imageHeight': h, 'imageWidth': w}
        ext = '.jpg' if fmt == 'JPEG' else '.png'
        if i % 4 < 2:
            record['imageData'] = base64.b64encode(data).decode()
            record['imagePath'] = f'missing{ext}'
        else:
            record['imagePath'] = f'photo_{i}{ext}'
            with open(os.path.join(labels, f'photo_{i}{ext}'), 'wb') as f:
                f.write(data)
        with open(os.path.join(labels, f'{i:02d}.json'), 'w') as f:
            json.dump(record, f)


def _tree(root):
    """{relative path: decoded pixels (or the text of data.yaml)}."""
    out = {}
    base = os.path.join(root, 'out')
    for d, _, files in os.walk(base):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, base)
            if name.endswith('.yaml'):
                with open(path) as f:
                    out[rel] = f.read()
            else:
                out[rel] = np.asarray(Image.open(path))
    return out


def test_tree_equals_the_jax_packages(tmp_path, capsys):
    root = str(tmp_path)
    labelme_folder(root)
    jax_check(root)
    want = _tree(root)
    check_semantic_segmentation_datasets(root)
    got = _tree(root)
    assert sorted(got) == sorted(want)
    assert sum(k.startswith('train/imgs') for k in got) == 24
    assert sum(k.startswith('val/imgs') for k in got) == 1
    assert got['data.yaml'] == want['data.yaml']
    assert 'names:\n  0: _background\n' in got['data.yaml']
    for k in want:
        if k != 'data.yaml':
            assert got[k].dtype == want[k].dtype == np.uint8
            np.testing.assert_array_equal(got[k], want[k], k)
    masks = [got[k] for k in got if 'masks' in k]
    assert len({int(v) for m in masks for v in np.unique(m)}) == 4


@pytest.mark.parametrize('factor,seed', [(0.8, 0), (0.5, 3)])
def test_split_equals_the_jax_packages(tmp_path, factor, seed):
    root = str(tmp_path)
    labelme_folder(root, n=10, seed=seed)
    jax_check(root, train_factor=factor, seed=seed)
    want = sorted(_tree(root))
    check_semantic_segmentation_datasets(root, train_factor=factor,
                                         seed=seed)
    assert sorted(_tree(root)) == want


def test_missing_labels_folder_is_reported(tmp_path, capsys):
    check_semantic_segmentation_datasets(str(tmp_path))
    assert 'not found' in capsys.readouterr().out
    assert not (tmp_path / 'out').exists()
