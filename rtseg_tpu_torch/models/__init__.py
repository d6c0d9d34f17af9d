from .bisenetv2 import BiSeNetv2
from .registry import PORTED, get_model

__all__ = ['BiSeNetv2', 'PORTED', 'get_model']
