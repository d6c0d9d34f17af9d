from .modules import (ACTIVATIONS, Activation, BatchNorm, Conv, ConvBNAct,
                      DeConvBNAct, DropPath, Dropout, Dropout2d,
                      DropoutMasks, DSConvBNAct, DWConvBNAct, GroupNorm,
                      LayerNorm, PReLU, PWConvBNAct, PyramidPoolingModule,
                      Recompute, SegHead, batch_norms, bind_dropout, conv1x1,
                      conv3x3, dense, dense_as_input, dropout_modules,
                      group_norm, layer_norm, sync_batch_norm)

__all__ = ['ACTIVATIONS', 'Activation', 'BatchNorm', 'Conv', 'ConvBNAct',
           'DeConvBNAct', 'DropPath', 'Dropout', 'Dropout2d', 'DropoutMasks',
           'DSConvBNAct', 'DWConvBNAct', 'GroupNorm', 'LayerNorm', 'PReLU',
           'PWConvBNAct', 'PyramidPoolingModule', 'Recompute', 'SegHead',
           'batch_norms', 'bind_dropout',
           'conv1x1', 'conv3x3', 'dense', 'dense_as_input',
           'dropout_modules', 'group_norm', 'layer_norm',
           'sync_batch_norm']
