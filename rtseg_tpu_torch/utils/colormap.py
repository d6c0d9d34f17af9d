"""Prediction colormaps (counterpart of rtseg_tpu/utils/colormap.py, the
same tables; reference utils/utils.py:59-78)."""

from __future__ import annotations

import numpy as np

# 19-class Cityscapes palette (reference utils/utils.py:61-65)
CITYSCAPES_COLORMAP = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
    [0, 80, 100], [0, 0, 230], [119, 11, 32]], dtype=np.uint8)


def get_colormap(config) -> np.ndarray:
    """(256, 3) uint8 LUT; unknown/void ids map to black."""
    lut = np.zeros((256, 3), np.uint8)
    if config.colormap == 'cityscapes':
        lut[:19] = CITYSCAPES_COLORMAP
    elif config.colormap == 'custom' or config.colormap == 'random':
        rng = np.random.RandomState(0)
        n = max(config.num_class, 1)
        lut[:n] = rng.randint(0, 255, (n, 3), dtype=np.uint8)
    else:
        raise NotImplementedError(
            f'Unsupported colormap: {config.colormap}')
    return lut
