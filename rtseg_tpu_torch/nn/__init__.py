from .modules import (ACTIVATIONS, Activation, BatchNorm, Conv, ConvBNAct,
                      DeConvBNAct, DSConvBNAct, DWConvBNAct, PReLU,
                      PWConvBNAct, PyramidPoolingModule, SegHead, dense)

__all__ = ['ACTIVATIONS', 'Activation', 'BatchNorm', 'Conv', 'ConvBNAct',
           'DeConvBNAct', 'DSConvBNAct', 'DWConvBNAct', 'PReLU',
           'PWConvBNAct', 'PyramidPoolingModule', 'SegHead', 'dense']
