"""Dataset preparation (counterpart of rtseg_tpu/utils/check_datasets.py;
reference utils/check_datasets.py:14-99): converts a folder of labelme
JSON polygon annotations into the Custom layout
(`out/{train,val}/{imgs,masks}` + data.yaml) with a 95/5 split.

As in the JAX package: each JSON's photo is its base64 `imageData`
(a JPEG or a PNG) or else the file `imagePath` names, relative to the
JSON; the split shuffles the sorted names with `random.Random(seed)` and
puts `round(train_factor * n)` in train; labels take ids in the order
they are first met, after `_background` 0. Images and masks are written
as PNGs (data/png.py), with the same pixels the JAX package writes
through PIL, and data.yaml with the same text.

`rasterize` replaces PIL's `ImageDraw.polygon(points, fill=class id)` on
an 'L' image and gives the same pixels (Pillow 12.1's Draw.c): vertices
truncated to integers, one edge a side (a horizontal run that goes on in
the same direction merges into one edge; a horizontal edge is drawn at
once), then a scanline over the rows the edges span, with the x of each
edge computed in float32, an edge ending on the row counted twice below
the last row, the corner where two edges meet joined to the next (or
previous) row's span when it would leave a gap of more than a pixel, and
each pair of sorted crossings filled from ROUND_UP(left) to
ROUND_DOWN(right).

Run it: `python -m rtseg_tpu_torch.utils.check_datasets --datasets_path
DIR` (DIR holds `labels/*.json`; the set goes to DIR/out).
"""

from __future__ import annotations

import argparse
import base64
import json
import math
import os
import random
import shutil
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data import image as image_file
from ..data import png

_F32 = np.float32


def _round_up(v: float) -> int:
    """Draw.c's ROUND_UP on a float: floor(v + 0.5F), mirrored below 0."""
    v = _F32(v)
    return int(math.floor(_F32(v + _F32(0.5))) if v >= 0
               else -math.floor(_F32(abs(v) + _F32(0.5))))


def _round_down(v: float) -> int:
    """Draw.c's ROUND_DOWN on a float: ceil(v - 0.5F), mirrored below 0."""
    v = _F32(v)
    return int(math.ceil(_F32(v - _F32(0.5))) if v >= 0
               else -math.ceil(_F32(abs(v) - _F32(0.5))))


def _roundf(v) -> float:
    """C's roundf: half away from zero."""
    v = float(v)
    return float(_F32(math.floor(v + 0.5) if v >= 0
                      else -math.floor(-v + 0.5)))


class _Edge:
    __slots__ = ('xmin', 'xmax', 'ymin', 'ymax', 'dx', 'x0', 'y0', 'xs')

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = _F32(0) if y0 == y1 else \
            _F32(_F32(x1 - x0) / _F32(y1 - y0))
        self.x0, self.y0 = x0, y0

    def at(self, y: int, base: int) -> float:
        return self.xs[y - base]


def _edges(xy: Sequence[Tuple[int, int]]) -> List[_Edge]:
    """ImagingDrawPolygon's edge list."""
    edges: List[_Edge] = []
    n = len(xy)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            # a horizontal edge that goes on the one before it
            if x1 > x0 > xy[i - 1][0]:
                edges[-1].xmax = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                edges[-1].xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xy[-1] != xy[0]:
        edges.append(_Edge(*xy[-1], *xy[0]))
    return edges


def rasterize_polygon(mask: np.ndarray, points: Sequence[Sequence[float]],
                      ink: int) -> None:
    """Fill the polygon `points` with `ink` in the 2-D uint8 `mask`, in
    place, as PIL's ImageDraw.polygon(points, fill=ink) does."""
    h, w = mask.shape
    xy = [(int(float(x)), int(float(y))) for x, y in points]

    def hline(x0: int, y: int, x1: int) -> None:
        if 0 <= y < h:
            x0 = max(x0, 0)
            if x0 >= w or x1 < 0:
                return
            x1 = min(x1, w - 1)
            if x0 <= x1:
                mask[y, x0:x1 + 1] = ink

    ymin, ymax, table = h - 1, 0, []
    for e in _edges(xy):
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            hline(e.xmin, e.ymin, e.xmax)
            continue
        table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, h)
    if ymin > ymax:
        return
    # each edge's float32 x on the rows ymin-1 .. ymax+1
    base = ymin - 1
    rows = np.arange(ymin - 1, ymax + 2)
    for e in table:
        e.xs = ((rows - e.y0).astype(_F32) * e.dx + _F32(e.x0)).tolist()
    for y in range(ymin, ymax + 1):
        xx: List[float] = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.at(y, base))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])            # consistent polygons
            elif (y == cur.ymin or y == cur.ymax) and cur.dx != 0:
                # join a corner to the next (or previous) row's span
                for other in table[:i]:
                    if (y != other.ymin and y != other.ymax) \
                            or other.dx == 0:
                        continue
                    if _roundf(xx[-1]) != _roundf(other.at(y, base)):
                        continue
                    step = -1 if y == cur.ymax else 1
                    if not other.ymin <= y + step <= other.ymax:
                        continue
                    a = cur.at(y + step, base)
                    b = other.at(y + step, base)
                    v = xx[-1]
                    if v > _F32(a + 1) and v > _F32(b + 1):
                        xx[-1] = float(_F32(_roundf(max(a, b)) + 1))
                    elif v < _F32(a - 1) and v < _F32(b - 1):
                        xx[-1] = float(_F32(_roundf(min(a, b)) - 1))
                    break
        xx.sort()
        for k in range(1, len(xx), 2):
            x0, x1 = _round_up(xx[k - 1]), _round_down(xx[k])
            if x1 >= x0:
                hline(x0, y, x1)


def rasterize(data: dict, class_name_to_id: Dict[str, int],
              size: Tuple[int, int]) -> np.ndarray:
    """The (height, width) uint8 class mask of a labelme record, `size`
    being (width, height) as PIL gives it."""
    w, h = size
    mask = np.zeros((h, w), np.uint8)
    for shape in data.get('shapes', []):
        if shape.get('shape_type', '') != 'polygon':
            continue
        cid = class_name_to_id.get(shape.get('label', 'None'))
        if cid is None:
            continue
        pts = [(float(x), float(y)) for x, y in shape.get('points', [])]
        if len(pts) >= 3:
            rasterize_polygon(mask, pts, cid)
    return mask


def load_image(label_path: str, data: dict) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a labelme record: its imageData, else the
    file its imagePath names beside the JSON."""
    if data.get('imageData'):
        return image_file.decode(base64.b64decode(data['imageData']), 'RGB',
                                 f'{label_path} imageData')
    return image_file.read(os.path.join(os.path.dirname(label_path),
                                        data.get('imagePath', '')), 'RGB')


def check_semantic_segmentation_datasets(datasets_path: str,
                                         train_factor: float = 0.95,
                                         seed: int = 0) -> None:
    labels_path = os.path.join(datasets_path, 'labels')
    if not os.path.exists(labels_path):
        print(f'Error: {labels_path} not found')
        return
    root = os.path.join(datasets_path, 'out')
    if os.path.exists(root):
        shutil.rmtree(root)
    dirs = {}
    for mode in ('train', 'val'):
        for sub in ('imgs', 'masks'):
            d = os.path.join(root, mode, sub)
            os.makedirs(d)
            dirs[(mode, sub)] = d

    all_data = sorted(i for i in os.listdir(labels_path)
                      if os.path.splitext(i)[1] == '.json')
    print('all_data:', len(all_data))
    rng = random.Random(seed)
    rng.shuffle(all_data)
    train_num = round(train_factor * len(all_data))

    # first pass: the label set, in the order labels are met
    class_name_to_id = {'_background': 0}
    parsed = {}
    for name in all_data:
        with open(os.path.join(labels_path, name)) as f:
            data = json.load(f)
        parsed[name] = data
        for shape in data.get('shapes', []):
            if shape.get('shape_type', '') == 'polygon':
                label = shape.get('label', 'None')
                if label not in class_name_to_id:
                    class_name_to_id[label] = len(class_name_to_id)
    print(class_name_to_id)

    # second pass: images and rasterized masks, split by the shuffle
    for idx, name in enumerate(all_data):
        mode = 'train' if idx < train_num else 'val'
        base = os.path.splitext(os.path.basename(name))[0]
        data = parsed[name]
        img = load_image(os.path.join(labels_path, name), data)
        mask = rasterize(data, class_name_to_id, (img.shape[1], img.shape[0]))
        with open(os.path.join(dirs[(mode, 'imgs')], f'{base}.png'),
                  'wb') as f:
            f.write(png.encode(img))
        with open(os.path.join(dirs[(mode, 'masks')], f'{base}.png'),
                  'wb') as f:
            f.write(png.encode(mask))

    # data.yaml for data/custom.py
    names = {v: k for k, v in class_name_to_id.items()}
    with open(os.path.join(root, 'data.yaml'), 'w') as f:
        f.write(f'path: {os.path.abspath(root)}\n')
        f.write('names:\n')
        for cid in sorted(names):
            f.write(f'  {cid}: {names[cid]}\n')
    print(f'Wrote {train_num} train / {len(all_data) - train_num} val '
          f'samples to {root}')


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--datasets_path', type=str, required=True)
    args = parser.parse_args()
    check_semantic_segmentation_datasets(args.datasets_path)
