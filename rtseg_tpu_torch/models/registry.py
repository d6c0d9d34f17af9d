"""Model registry of the port (counterpart of rtseg_tpu/models/registry.py).

Ported: BiSeNetv1, BiSeNetv2, CANet, CFPNet, DABNet, DDRNet, ERFNet,
ESNet, FarSeeNet, FastSCNN, FDDWNet, FSSNet, ICNet, LinkNet, LiteSeg,
MiniNetv2, PP-LiteSeg, ShelfNet, STDC and SwiftNet, each at its JAX
registry defaults. Every other name of the JAX zoo raises
NotImplementedError, and ROADMAP.md holds the order in which they come.
Aux heads are built only for the aux models and the detail head only for
the detail models; asking either of another model raises ValueError.
"""

from __future__ import annotations

from .bisenetv1 import BiSeNetv1
from .bisenetv2 import BiSeNetv2
from .canet import CANet
from .cfpnet import CFPNet
from .dabnet import DABNet
from .ddrnet import DDRNet
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
from .shelfnet import ShelfNet
from .stdc import STDC
from .swiftnet import SwiftNet

# the models built from num_class alone
_PLAIN = {'bisenetv1': BiSeNetv1, 'canet': CANet, 'cfpnet': CFPNet,
          'dabnet': DABNet, 'erfnet': ERFNet, 'esnet': ESNet,
          'farseenet': FarSeeNet, 'fastscnn': FastSCNN, 'fddwnet': FDDWNet,
          'fssnet': FSSNet, 'linknet': LinkNet, 'liteseg': LiteSeg,
          'mininetv2': MiniNetv2, 'shelfnet': ShelfNet,
          'swiftnet': SwiftNet}
PORTED = tuple(sorted(('bisenetv2', 'ddrnet', 'icnet', 'ppliteseg', 'stdc')
                      + tuple(_PLAIN)))
AUX_MODELS = ('bisenetv2', 'ddrnet', 'icnet')
DETAIL_HEAD_MODELS = ('stdc',)


def get_model(config, device=None):
    """Build the port's module for config.model with parameters on
    `device` (uninitialized: load weights with utils.convert)."""
    name = config.model
    if name not in PORTED:
        raise NotImplementedError(
            f'Model {name!r} is not ported to PyTorch yet (ported: '
            f'{", ".join(PORTED)}); see ROADMAP.md Queue 1')
    if config.use_aux and name not in AUX_MODELS + DETAIL_HEAD_MODELS:
        raise ValueError(f'Model {name} does not support auxiliary heads.')
    if config.use_detail_head and name not in DETAIL_HEAD_MODELS:
        raise ValueError(f'Model {name} does not support detail heads.')
    nc = config.num_class
    if name == 'bisenetv2':
        return BiSeNetv2(num_class=nc, use_aux=config.use_aux,
                         detail_remat=config.detail_remat,
                         pack_fullres=config.pack_fullres,
                         hires_remat=config.hires_remat,
                         s2d_stem=config.s2d_stem, device=device)
    if name == 'ddrnet':
        return DDRNet(num_class=nc, use_aux=config.use_aux,
                      hires_remat=config.hires_remat, device=device)
    if name == 'icnet':
        return ICNet(num_class=nc, use_aux=config.use_aux, device=device)
    if name == 'stdc':
        return STDC(num_class=nc, use_detail_head=config.use_detail_head,
                    use_aux=config.use_aux, hires_remat=config.hires_remat,
                    device=device)
    if name == 'ppliteseg':
        return PPLiteSeg(num_class=nc, hires_remat=config.hires_remat,
                         device=device)
    return _PLAIN[name](num_class=nc, device=device)
