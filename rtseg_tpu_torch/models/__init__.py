from .bisenetv1 import BiSeNetv1
from .bisenetv2 import BiSeNetv2
from .canet import CANet
from .ddrnet import DDRNet
from .farseenet import FarSeeNet
from .fastscnn import FastSCNN
from .icnet import ICNet
from .linknet import LinkNet
from .liteseg import LiteSeg
from .registry import PORTED, get_model
from .shelfnet import ShelfNet
from .stdc import STDC
from .swiftnet import SwiftNet

__all__ = ['BiSeNetv1', 'BiSeNetv2', 'CANet', 'DDRNet', 'FarSeeNet',
           'FastSCNN', 'ICNet', 'LinkNet', 'LiteSeg', 'PORTED', 'ShelfNet',
           'STDC', 'SwiftNet', 'get_model']
