from .adscnet import ADSCNet
from .aglnet import AGLNet
from .bisenetv1 import BiSeNetv1
from .bisenetv2 import BiSeNetv2
from .canet import CANet
from .cfpnet import CFPNet
from .cgnet import CGNet
from .contextnet import ContextNet
from .dabnet import DABNet
from .ddrnet import DDRNet
from .dfanet import DFANet
from .edanet import EDANet
from .enet import ENet, InitialBlock
from .erfnet import ERFNet
from .esnet import ESNet
from .espnet import ESPNet
from .espnetv2 import ESPNetv2
from .farseenet import FarSeeNet
from .fastscnn import FastSCNN
from .fddwnet import FDDWNet
from .fpenet import FPENet
from .fssnet import FSSNet
from .icnet import ICNet
from .lednet import LEDNet
from .linknet import LinkNet
from .lite_hrnet import LiteHRNet
from .liteseg import LiteSeg
from .mininet import MiniNet
from .mininetv2 import MiniNetv2
from .pp_liteseg import PPLiteSeg
from .registry import PORTED, get_model, get_teacher_model
from .regseg import RegSeg
from .segnet import SegNet
from .shelfnet import ShelfNet
from .sqnet import SQNet
from .stdc import STDC
from .swiftnet import SwiftNet

__all__ = ['ADSCNet', 'AGLNet', 'BiSeNetv1', 'BiSeNetv2', 'CANet', 'CFPNet',
           'CGNet', 'ContextNet', 'DABNet', 'DDRNet', 'DFANet', 'EDANet',
           'ENet', 'ERFNet', 'ESNet', 'ESPNet', 'ESPNetv2', 'FarSeeNet',
           'FastSCNN', 'FDDWNet', 'FPENet', 'FSSNet', 'get_model',
           'get_teacher_model', 'ICNet',
           'InitialBlock', 'LEDNet', 'LinkNet', 'LiteHRNet', 'LiteSeg',
           'MiniNet', 'MiniNetv2', 'PORTED', 'PPLiteSeg', 'RegSeg', 'SegNet',
           'ShelfNet', 'SQNet', 'STDC', 'SwiftNet']
