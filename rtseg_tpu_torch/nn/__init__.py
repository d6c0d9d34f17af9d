from .modules import (ACTIVATIONS, Activation, BatchNorm, Conv, ConvBNAct,
                      DeConvBNAct, Dropout, Dropout2d, DropoutMasks,
                      DSConvBNAct, DWConvBNAct, PReLU, PWConvBNAct,
                      PyramidPoolingModule, SegHead, bind_dropout, conv1x1,
                      conv3x3, dense, dropout_modules)

__all__ = ['ACTIVATIONS', 'Activation', 'BatchNorm', 'Conv', 'ConvBNAct',
           'DeConvBNAct', 'Dropout', 'Dropout2d', 'DropoutMasks',
           'DSConvBNAct', 'DWConvBNAct', 'PReLU', 'PWConvBNAct',
           'PyramidPoolingModule', 'SegHead', 'bind_dropout', 'conv1x1',
           'conv3x3', 'dense', 'dropout_modules']
