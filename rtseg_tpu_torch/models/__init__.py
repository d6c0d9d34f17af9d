from .bisenetv1 import BiSeNetv1
from .bisenetv2 import BiSeNetv2
from .canet import CANet
from .cfpnet import CFPNet
from .dabnet import DABNet
from .ddrnet import DDRNet
from .enet import InitialBlock
from .erfnet import ERFNet
from .esnet import ESNet
from .farseenet import FarSeeNet
from .fastscnn import FastSCNN
from .fddwnet import FDDWNet
from .fssnet import FSSNet
from .icnet import ICNet
from .linknet import LinkNet
from .liteseg import LiteSeg
from .mininetv2 import MiniNetv2
from .pp_liteseg import PPLiteSeg
from .registry import PORTED, get_model
from .shelfnet import ShelfNet
from .stdc import STDC
from .swiftnet import SwiftNet

__all__ = ['BiSeNetv1', 'BiSeNetv2', 'CANet', 'CFPNet', 'DABNet', 'DDRNet',
           'ERFNet', 'ESNet', 'FarSeeNet', 'FastSCNN', 'FDDWNet', 'FSSNet',
           'ICNet', 'InitialBlock', 'LinkNet', 'LiteSeg', 'MiniNetv2',
           'PORTED', 'PPLiteSeg', 'ShelfNet', 'STDC', 'SwiftNet',
           'get_model']
