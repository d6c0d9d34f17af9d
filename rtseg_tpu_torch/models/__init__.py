from .bisenetv2 import BiSeNetv2
from .ddrnet import DDRNet
from .fastscnn import FastSCNN
from .registry import PORTED, get_model
from .stdc import STDC

__all__ = ['BiSeNetv2', 'DDRNet', 'FastSCNN', 'PORTED', 'STDC', 'get_model']
