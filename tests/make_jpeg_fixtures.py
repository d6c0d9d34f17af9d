"""Write the JPEG fixtures of tests/data/jpeg/ with PIL, and digests.json
beside them: each file's decoded shape and the sha256 of PIL's
`Image.open(f).convert('RGB')` bytes, which the port's decoder
(rtseg_tpu_torch/data/jpeg.py) must reproduce, here in the tests and on
the card in chip_smoke.py (whose machine has no PIL).

    python tests/make_jpeg_fixtures.py

* three 1024x2048 street-like scenes made from a numpy seed (sky,
  buildings with windows, trees, a road with lane marks, cars), with the
  polygons of their road (label 'road') for the labelme sets chip_smoke
  builds: baseline 4:2:0 quality 90, progressive 4:2:0 quality 90, and
  4:2:2 quality 75 with a restart marker every 7 MCUs;
* small files over the options of PIL's encoder: subsampling 4:4:4,
  4:2:2 and 4:2:0, progressive, optimized Huffman tables, restart markers
  by blocks and by rows, gray, gray progressive (the AC refinement scans
  without colour), RGB-coded (keep_rgb), 16-bit quantization tables
  (SOF1), sizes that are not multiples of 8 or 16, and 1x1.

The files are written once and committed; PIL 12.1 on libjpeg-turbo 3.1
made them. At most 1.5 MB in all.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image, ImageDraw

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                    'jpeg')
STREET = (1024, 2048)


def street(seed: int):
    """(H, W, 3) uint8 scene and its road polygons [(label, points)]."""
    rng = np.random.default_rng(seed)
    h, w = STREET
    img = Image.new('RGB', (w, h))
    d = ImageDraw.Draw(img)
    horizon = int(rng.integers(520, 600))
    for y in range(horizon):                            # sky gradient
        t = y / horizon
        d.line([(0, y), (w, y)], fill=(int(90 + 100 * t), int(140 + 80 * t),
                                       int(220 - 20 * t)))
    x = 0
    while x < w:                                        # buildings
        bw = int(rng.integers(120, 360))
        top = int(rng.integers(80, horizon - 100))
        tone = rng.integers(60, 200, 3)
        d.rectangle([x, top, x + bw, horizon], fill=tuple(int(v) for v in tone))
        for wy in range(top + 20, horizon - 30, 48):
            for wx in range(x + 14, x + bw - 24, 40):
                d.rectangle([wx, wy, wx + 18, wy + 26],
                            fill=tuple(int(v) for v in tone // 3 + 30))
        x += bw + int(rng.integers(0, 40))
    for _ in range(6):                                  # trees
        cx, cy, r = rng.integers(0, w), horizon - rng.integers(0, 60), \
            rng.integers(40, 110)
        d.ellipse([cx - r, cy - 2 * r, cx + r, cy],
                  fill=(int(rng.integers(20, 60)), int(rng.integers(90, 150)),
                        int(rng.integers(20, 60))))
    d.rectangle([0, horizon, w, h], fill=(150, 150, 140))   # sidewalk
    mid = w / 2 + rng.uniform(-200, 200)
    road = [(mid - 60.5, horizon + 0.5), (mid + 60.5, horizon + 0.5),
            (w - rng.uniform(0, 300), h - 0.25), (rng.uniform(0, 300),
                                                  h - 0.25)]
    d.polygon(road, fill=(80, 80, 86))
    for k in range(8):                                  # lane marks
        t0, t1 = k / 8, (k + 0.5) / 8
        y0, y1 = horizon + t0 * (h - horizon), horizon + t1 * (h - horizon)
        d.polygon([(mid - 2 - 10 * t0, y0), (mid + 2 + 10 * t0, y0),
                   (mid + 2 + 10 * t1, y1), (mid - 2 - 10 * t1, y1)],
                  fill=(235, 235, 225))
    cars = []
    for _ in range(int(rng.integers(2, 5))):            # cars on the road
        cy = int(rng.integers(horizon + 80, h - 120))
        s = (cy - horizon) / (h - horizon)
        cw, ch = int(120 + 260 * s), int(60 + 140 * s)
        cx = int(mid + rng.uniform(-0.8, 0.8) * (60 + 800 * s))
        colour = tuple(int(v) for v in rng.integers(20, 235, 3))
        d.rounded_rectangle([cx - cw // 2, cy - ch, cx + cw // 2, cy],
                            radius=12, fill=colour)
        d.rectangle([cx - cw // 3, cy - ch + 8, cx + cw // 3,
                     cy - ch // 2], fill=(30, 40, 50))
        cars.append([(cx - cw / 2, cy - ch), (cx + cw / 2, cy - ch),
                     (cx + cw / 2, cy), (cx - cw / 2, cy)])
    arr = np.asarray(img).astype(np.int16)
    arr = arr + rng.normal(0, 2.0, arr.shape).round().astype(np.int16)
    polygons = [('road', [list(map(float, p)) for p in road])]
    polygons += [('car', [list(map(float, p)) for p in c]) for c in cars]
    return np.clip(arr, 0, 255).astype(np.uint8), polygons


def small(seed: int, h: int, w: int, gray: bool = False) -> np.ndarray:
    """A smooth image with texture, so that every scan carries data."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    a = 128 + 90 * np.sin(7 * x + 3 * y + np.arange(3)) \
        + rng.normal(0, 18, (h, w, 3))
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a[..., 0] if gray else a


# name -> (image, PIL save options)
def fixtures():
    out = {}
    polys = {}
    for i, (name, opts) in enumerate((
            ('street_baseline_420_q90.jpg', dict(quality=90)),
            ('street_progressive_420_q90.jpg', dict(quality=90,
                                                    progressive=True)),
            ('street_422_q75_rst.jpg', dict(quality=75, subsampling=1,
                                            restart_marker_blocks=7)))):
        img, p = street(100 + i)
        out[name] = (img, opts)
        polys[name] = p
    out.update({
        'small_444_33x17.jpg': (small(1, 33, 17), dict(subsampling=0)),
        'small_422_9x23.jpg': (small(2, 9, 23), dict(subsampling=1)),
        'small_420_17x7.jpg': (small(3, 17, 7), dict(subsampling=2)),
        'small_420_1x1.jpg': (small(4, 1, 1), dict()),
        'small_420_3x5.jpg': (small(5, 3, 5), dict(quality=60)),
        'small_progressive_420_41x37.jpg': (small(6, 41, 37),
                                            dict(progressive=True)),
        'small_progressive_444_rows_29x45.jpg': (
            small(7, 29, 45), dict(progressive=True, subsampling=0,
                                   restart_marker_rows=1)),
        'small_optimize_422_rst_31x50.jpg': (
            small(8, 31, 50), dict(optimize=True, subsampling=1,
                                   restart_marker_blocks=3)),
        'small_gray_19x33.jpg': (small(9, 19, 33, gray=True), dict()),
        'small_gray_progressive_65x47.jpg': (small(10, 65, 47, gray=True),
                                             dict(progressive=True)),
        'small_rgb_keep_15x21.jpg': (small(11, 15, 21),
                                     dict(keep_rgb=True)),
        'small_sof1_16bit_qt_24x40.jpg': (
            small(12, 24, 40), dict(qtables=[[300] * 64, [200] * 64])),
    })
    return out, polys


def main() -> None:
    os.makedirs(HERE, exist_ok=True)
    table, polys = fixtures()
    digests = {}
    total = 0
    for name, (img, opts) in table.items():
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, 'JPEG', **opts)
        data = buf.getvalue()
        total += len(data)
        with open(os.path.join(HERE, name), 'wb') as f:
            f.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))
        digests[name] = {'shape': list(rgb.shape),
                         'sha256': hashlib.sha256(rgb.tobytes()).hexdigest(),
                         'bytes': len(data), 'options': {
                             k: v for k, v in opts.items()
                             if k != 'qtables'}}
        if 'qtables' in opts:
            digests[name]['options']['qtables'] = [t[0] for t in
                                                   opts['qtables']]
        if name in polys:
            digests[name]['polygons'] = polys[name]
    with open(os.path.join(HERE, 'digests.json'), 'w') as f:
        json.dump(digests, f, indent=1)
        f.write('\n')
    print(f'{len(digests)} fixtures, {total} bytes, in {HERE}')


if __name__ == '__main__':
    main()
