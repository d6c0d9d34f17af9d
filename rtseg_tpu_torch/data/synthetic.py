"""Deterministic learnable synthetic dataset (a copy of
rtseg_tpu/data/synthetic.py, numpy only).

Each sample is a blocky class field (8x8-pixel cells) rendered through a
fixed class->color palette with additive noise. Content depends only on
(mode, index), so both packages see the same samples.
"""

from __future__ import annotations

import numpy as np

_CELL = 8          # class-field cell size in pixels
_NOISE = 0.08      # additive image noise amplitude


class Synthetic:
    # float-native samples: no exact uint8 hand-off (data.get_loader's
    # device_norm)
    supports_raw_tail = False

    def __init__(self, config, mode: str = 'train', length: int = None):
        self.h = config.crop_h
        self.w = config.crop_w
        self.num_class = max(config.num_class, 2)
        if length is None:
            base = getattr(config, 'synthetic_len', 64)
            length = base if mode == 'train' else max(16, base // 4)
        self.length = length
        self.mode = mode
        # fixed palette shared by all samples/modes: what the model learns
        self.palette = np.random.default_rng(12345).random(
            (self.num_class, 3)).astype(np.float32)

    def __len__(self):
        return self.length

    def get(self, index: int, rng: np.random.Generator = None):
        # val never aliases train samples
        seed = index if self.mode == 'train' else 1_000_003 + index
        local = np.random.default_rng(seed)
        fh = max(1, self.h // _CELL)
        fw = max(1, self.w // _CELL)
        small = local.integers(0, self.num_class, (fh, fw))
        rows = (np.arange(self.h) * fh) // self.h
        cols = (np.arange(self.w) * fw) // self.w
        mask = small[rows][:, cols].astype(np.int32)
        image = self.palette[mask]
        image += _NOISE * local.standard_normal(image.shape).astype(np.float32)
        return np.clip(image, 0.0, 1.0).astype(np.float32), mask
