"""Small PNG trees in the Cityscapes and Custom layouts for the port's data
tests (tests/test_torch_data_*.py, tests/test_torch_main.py), made from a
seed. Images alternate between files PIL writes and files the port's
encoder writes with its filter types cycled row by row."""

import os

import numpy as np
from PIL import Image

from rtseg_tpu_torch.data import png
from rtseg_tpu_torch.data.cityscapes import LABELS


def write_png(path, array, index: int) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if index % 2:
        with open(path, 'wb') as f:
            f.write(png.encode(array, (0, 1, 2, 3, 4), idat_chunks=2))
    else:
        Image.fromarray(array).save(path)


def cityscapes_tree(root, n_train=6, n_val=3, hw=(40, 72), seed=0) -> str:
    """<root>/leftImg8bit/<mode>/<city>/*_leftImg8bit.png and the gtFine
    labelIds masks (raw ids 0-33, every id of the table) in two cities."""
    rng = np.random.default_rng(seed)
    ids = np.array([l.id for l in LABELS if l.id >= 0], np.uint8)
    for mode, n in (('train', n_train), ('val', n_val)):
        for i in range(n):
            city = ('aachen', 'bremen')[i % 2]
            stem = f'{city}_{i:06d}_000019'
            write_png(os.path.join(root, 'leftImg8bit', mode, city,
                                   f'{stem}_leftImg8bit.png'),
                      rng.integers(0, 256, hw + (3,), dtype=np.uint8), i)
            write_png(os.path.join(root, 'gtFine', mode, city,
                                   f'{stem}_gtFine_labelIds.png'),
                      rng.choice(ids, hw).astype(np.uint8), i + 1)
    return str(root)


def custom_tree(root, n_train=6, n_val=3, hw=(40, 50), num_class=3,
                seed=7) -> str:
    """<root>/data.yaml, <root>/<mode>/imgs/*.png and masks/*.png."""
    rng = np.random.default_rng(seed)
    for mode, n in (('train', n_train), ('val', n_val)):
        for i in range(n):
            write_png(os.path.join(root, mode, 'imgs', f'{i}.png'),
                      rng.integers(0, 256, hw + (3,), dtype=np.uint8), i)
            write_png(os.path.join(root, mode, 'masks', f'{i}.png'),
                      rng.integers(0, num_class, hw, dtype=np.uint8), i + 1)
    names = '\n'.join(f'  {k}: class{k}' for k in range(num_class))
    with open(os.path.join(root, 'data.yaml'), 'w') as f:
        f.write(f'path: {root}\nnames:\n{names}\n')
    return str(root)


class Boom:
    """A dataset of the plain get(i, rng) protocol whose sample 3 raises,
    or, with kill, ends its process without a word (as a crash would)."""

    def __init__(self, n=8, kill=False):
        self.n = n
        self.kill = kill

    def __len__(self):
        return self.n

    def get(self, i, rng):
        if i == 3:
            if self.kill:
                os._exit(3)
            raise ValueError('boom at 3')
        return (np.full((4, 4, 3), i, np.float32),
                np.full((4, 4), i, np.int32))
