from .modules import (ACTIVATIONS, Activation, BatchNorm, Conv, ConvBNAct,
                      DeConvBNAct, DSConvBNAct, DWConvBNAct, PReLU,
                      PWConvBNAct, PyramidPoolingModule, SegHead)

__all__ = ['ACTIVATIONS', 'Activation', 'BatchNorm', 'Conv', 'ConvBNAct',
           'DeConvBNAct', 'DSConvBNAct', 'DWConvBNAct', 'PReLU',
           'PWConvBNAct', 'PyramidPoolingModule', 'SegHead']
