from .fused_head import resize_argmax
from .pallas_metrics import confusion_matrix_pallas
from .pool import avg_pool, global_avg_pool, max_pool
from .resize import final_upsample, resize_bilinear, resize_nearest

__all__ = ['resize_argmax', 'confusion_matrix_pallas',
           'avg_pool', 'global_avg_pool', 'max_pool', 'final_upsample',
           'resize_bilinear', 'resize_nearest']
