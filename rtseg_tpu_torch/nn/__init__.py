from .modules import (ACTIVATIONS, Activation, BatchNorm, Conv, ConvBNAct,
                      DWConvBNAct, PReLU, PWConvBNAct, SegHead)

__all__ = ['ACTIVATIONS', 'Activation', 'BatchNorm', 'Conv', 'ConvBNAct',
           'DWConvBNAct', 'PReLU', 'PWConvBNAct', 'SegHead']
