from .colormap import CITYSCAPES_COLORMAP, get_colormap
from .convert import (flax_init_variables, from_jax_variables,
                      load_jax_variables, random_jax_variables,
                      to_jax_variables)
from .metrics import confusion_matrix, iou_from_cm, miou_from_cm

__all__ = ['CITYSCAPES_COLORMAP', 'get_colormap', 'flax_init_variables',
           'from_jax_variables', 'load_jax_variables', 'random_jax_variables',
           'to_jax_variables', 'confusion_matrix', 'iou_from_cm',
           'miou_from_cm']
