"""Cityscapes dataset (counterpart of rtseg_tpu/data/cityscapes.py).

The 35-entry label table with the 19 train classes; raw label ids are
encoded to trainIds through a numpy table after augmentation. Layout:
    <root>/leftImg8bit/<mode>/<city>/*_leftImg8bit.png
    <root>/gtFine/<mode>/<city>/*_gtFine_labelIds.png
"""

from __future__ import annotations

import os
from collections import namedtuple

import numpy as np

from .protocol import SegpipeFileDataset
from .transforms import EvalTransform, TrainTransform

Label = namedtuple('Label', ['name', 'id', 'trainId'])

# (name, id, trainId) triplets of the official Cityscapes label set.
LABELS = [
    Label('unlabeled', 0, 255), Label('ego vehicle', 1, 255),
    Label('rectification border', 2, 255), Label('out of roi', 3, 255),
    Label('static', 4, 255), Label('dynamic', 5, 255),
    Label('ground', 6, 255), Label('road', 7, 0),
    Label('sidewalk', 8, 1), Label('parking', 9, 255),
    Label('rail track', 10, 255), Label('building', 11, 2),
    Label('wall', 12, 3), Label('fence', 13, 4),
    Label('guard rail', 14, 255), Label('bridge', 15, 255),
    Label('tunnel', 16, 255), Label('pole', 17, 5),
    Label('polegroup', 18, 255), Label('traffic light', 19, 6),
    Label('traffic sign', 20, 7), Label('vegetation', 21, 8),
    Label('terrain', 22, 9), Label('sky', 23, 10),
    Label('person', 24, 11), Label('rider', 25, 12),
    Label('car', 26, 13), Label('truck', 27, 14),
    Label('bus', 28, 15), Label('caravan', 29, 255),
    Label('trailer', 30, 255), Label('train', 31, 16),
    Label('motorcycle', 32, 17), Label('bicycle', 33, 18),
    Label('license plate', -1, 255),
]

ID_TO_TRAIN_ID = np.array([l.trainId for l in LABELS if l.id >= 0],
                          dtype=np.uint8)


def encode_target(mask: np.ndarray) -> np.ndarray:
    """Raw ids -> trainIds via the table."""
    return ID_TO_TRAIN_ID[np.clip(mask, 0, len(ID_TO_TRAIN_ID) - 1)]


class Cityscapes(SegpipeFileDataset):
    num_class = 19
    spec_name = 'cityscapes'

    def __init__(self, config, mode: str = 'train'):
        data_root = os.path.expanduser(config.data_root)
        img_dir = os.path.join(data_root, 'leftImg8bit', mode)
        msk_dir = os.path.join(data_root, 'gtFine', mode)
        if not os.path.isdir(img_dir):
            raise RuntimeError(f'Image directory: {img_dir} does not exist.')
        if not os.path.isdir(msk_dir):
            raise RuntimeError(f'Mask directory: {msk_dir} does not exist.')

        self.transform = (TrainTransform(config) if mode == 'train'
                          else EvalTransform(config))
        self.images, self.masks = [], []
        for city in sorted(os.listdir(img_dir)):
            city_img = os.path.join(img_dir, city)
            city_msk = os.path.join(msk_dir, city)
            for fn in sorted(os.listdir(city_img)):
                self.images.append(os.path.join(city_img, fn))
                mask_name = f"{fn.split('_leftImg8bit')[0]}_gtFine_labelIds.png"
                self.masks.append(os.path.join(city_msk, mask_name))

    # masks stay raw label ids in the packed cache: PadIfNeeded pads masks
    # with 0, which must mean "unlabeled", so the trainId table runs after
    # augment
    def _encode_mask(self, mask: np.ndarray) -> np.ndarray:
        return encode_target(mask).astype(np.int32)
