"""Inference-time folder dataset (counterpart of
rtseg_tpu/data/test_folder.py; reference datasets/test_dataset.py:10-40):
a flat directory of images -> (raw image, normalized image, filename).

The port decodes PNGs and JPEGs (data/image.py): a file of another
format raises NotImplementedError when the folder is opened; it is never
skipped."""

from __future__ import annotations

import os

from . import image as image_file
from .transforms import EvalTransform


class TestFolder:
    __test__ = False                 # not a pytest class, despite its name

    def __init__(self, config):
        folder = os.path.expanduser(config.test_data_folder)
        if not os.path.isdir(folder):
            raise RuntimeError(
                f'Test image directory: {folder} does not exist.')
        self.transform = EvalTransform(config)
        self.images = []
        self.img_names = []
        for fn in sorted(os.listdir(folder)):
            path = os.path.join(folder, fn)
            with open(path, 'rb') as f:
                image_file.kind(f.read(image_file.HEAD), path)
            self.images.append(path)
            self.img_names.append(fn)

    def __len__(self):
        return len(self.images)

    def get(self, index: int, rng=None):
        image = image_file.read(self.images[index], 'RGB')
        aug = self.transform(image, None, rng)
        return image, aug, self.img_names[index]

    def shape(self, index: int):
        """Post-transform (h, w) from the file's header alone (no decode),
        through EvalTransform's only shape-changing step here
        (transforms.scale, which truncates with int()): how prediction
        finds a folder's buckets without holding any image."""
        h, w = image_file.read_size(self.images[index])
        factor = self.transform.config.scale
        if factor != 1.0:
            h, w = int(h * factor), int(w * factor)
        return h, w
