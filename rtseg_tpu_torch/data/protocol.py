"""Shared segpipe protocol for file-backed datasets (counterpart of
rtseg_tpu/data/protocol.py), reading PNG and JPEG images through
data/image.py and PNG masks through data/png.py.

``get == augment(*prepare(i), rng)``: ``prepare`` is the deterministic
decode + resize head the packed cache stores once; ``augment`` /
``augment_raw`` are the random suffix (host normalize or raw uint8).
Subclasses provide ``images`` / ``masks`` / ``transform`` and override:

  * ``spec_name``, the dataset tag in the cache's content hash;
  * ``_encode_mask``, the mask post-processing after the augment suffix
    (Cityscapes' raw id -> trainId table; an int32 cast for Custom). After
    it, because PadIfNeeded pads masks with raw 0, which must keep its
    raw-id meaning until encoding; the table is elementwise, so it
    commutes with the flips ``augment_raw`` leaves to the card.
"""

from __future__ import annotations

import os

import numpy as np

from . import image as image_file
from . import png


class SegpipeFileDataset:
    spec_name = 'custom'

    def __len__(self):
        return len(self.images)

    def _encode_mask(self, mask: np.ndarray) -> np.ndarray:
        return mask.astype(np.int32)

    def prepare(self, index: int):
        image = image_file.read(self.images[index], 'RGB')
        mask = png.read(self.masks[index], 'L')
        return self.transform.prefix(image, mask)

    def augment(self, image, mask, rng: np.random.Generator):
        image, mask = self.transform.suffix(image, mask, rng)
        return image, self._encode_mask(mask)

    def augment_raw(self, image, mask, rng: np.random.Generator):
        """uint8 image + unflipped encoded mask + flip draws, for the
        card's flip/normalize stage (ops/augment.py)."""
        image, mask, flips = self.transform.suffix_raw(image, mask, rng)
        return image, self._encode_mask(mask), flips

    @property
    def supports_raw_tail(self) -> bool:
        return self.transform.supports_raw_tail

    def norm_coeffs(self):
        return self.transform.norm_coeffs()

    def cache_spec(self) -> dict:
        """Identity of the prepare() output for the packed cache's content
        hash: the source files (path, size, mtime_ns) and the prefix
        stage's transform config. The JAX package's, key for key, so each
        package finds a cache the other built."""
        c = self.transform.config
        files = []
        for p in (*self.images, *self.masks):
            st = os.stat(p)
            files.append((p, st.st_size, st.st_mtime_ns))
        return {'dataset': self.spec_name, 'scale': c.scale,
                'square': self.transform.square_size, 'files': files}

    def get(self, index: int, rng: np.random.Generator):
        image, mask = self.prepare(index)
        return self.augment(image, mask, rng)
