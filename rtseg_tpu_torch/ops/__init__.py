from .augment import device_flip_norm, device_normalize
from .fused_head import resize_argmax
from .pallas_metrics import confusion_matrix_pallas
from .pool import (adaptive_avg_pool, adaptive_max_pool, avg_pool,
                   global_avg_pool, max_pool, max_pool_argmax_2x2,
                   max_unpool_2x2)
from .resize import (final_upsample, pixel_shuffle, resize_bilinear,
                     resize_nearest)
from .shuffle import channel_shuffle, channel_split

__all__ = ['device_flip_norm', 'device_normalize', 'resize_argmax', 'confusion_matrix_pallas', 'adaptive_avg_pool',
           'adaptive_max_pool', 'avg_pool', 'global_avg_pool', 'max_pool',
           'max_pool_argmax_2x2', 'max_unpool_2x2', 'final_upsample',
           'pixel_shuffle', 'resize_bilinear', 'resize_nearest',
           'channel_shuffle', 'channel_split']
