"""Model registry of the port (counterpart of rtseg_tpu/models/registry.py).

Ported: every name of the JAX registry's MODEL_REGISTRY (36): ADSCNet,
AGLNet, BiSeNetv1, BiSeNetv2, CANet, CFPNet, CGNet, ContextNet, DABNet,
DDRNet, DFANet, EDANet, ENet, ERFNet, ESNet, ESPNet, ESPNetv2, FarSeeNet,
FastSCNN, FDDWNet, FPENet, FSSNet, ICNet, LEDNet, LinkNet, Lite-HRNet
(litehrnet18), LiteSeg, MiniNet, MiniNetv2, PP-LiteSeg, RegSeg, SegNet,
ShelfNet, SQNet, STDC and SwiftNet, each at its JAX registry defaults,
and `model='smp'`, the encoder-decoder hub (models/smp.py) on
config.encoder and config.decoder, which also builds the KD teacher
(`get_teacher_model`).
Aux heads are built only for the aux models and the detail head only for
the detail models; asking either of another model, `smp` included (whose
JAX step would fail later, unpacking the one output), raises ValueError.
"""

from __future__ import annotations

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
from .enet import ENet
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
from .regseg import RegSeg
from .segnet import SegNet
from .shelfnet import ShelfNet
from .smp import SMP_DECODERS, build_smp_model
from .sqnet import SQNet
from .stdc import STDC
from .swiftnet import SwiftNet

# the models built from num_class alone
_PLAIN = {'adscnet': ADSCNet, 'aglnet': AGLNet, 'bisenetv1': BiSeNetv1,
          'canet': CANet, 'cfpnet': CFPNet, 'cgnet': CGNet,
          'contextnet': ContextNet, 'dabnet': DABNet, 'dfanet': DFANet,
          'edanet': EDANet, 'enet': ENet, 'erfnet': ERFNet, 'esnet': ESNet,
          'espnet': ESPNet, 'espnetv2': ESPNetv2, 'farseenet': FarSeeNet,
          'fastscnn': FastSCNN, 'fddwnet': FDDWNet, 'fpenet': FPENet,
          'fssnet': FSSNet, 'lednet': LEDNet, 'linknet': LinkNet,
          'lite_hrnet': LiteHRNet, 'liteseg': LiteSeg, 'mininet': MiniNet,
          'mininetv2': MiniNetv2, 'regseg': RegSeg, 'shelfnet': ShelfNet,
          'sqnet': SQNet, 'swiftnet': SwiftNet}
PORTED = tuple(sorted(('bisenetv2', 'ddrnet', 'icnet', 'ppliteseg', 'segnet',
                       'stdc') + tuple(_PLAIN)))
AUX_MODELS = ('bisenetv2', 'ddrnet', 'icnet')
DETAIL_HEAD_MODELS = ('stdc',)


def get_model(config, device=None):
    """Build the port's module for config.model with parameters on
    `device` (uninitialized: load weights with utils.convert)."""
    name = config.model
    if name != 'smp' and name not in PORTED:
        raise NotImplementedError(
            f'Model {name!r} is not ported to PyTorch yet (ported: '
            f'{", ".join(PORTED)}); see ROADMAP.md Queue 1')
    if config.use_aux and name not in AUX_MODELS + DETAIL_HEAD_MODELS:
        raise ValueError(f'Model {name} does not support auxiliary heads.')
    if config.use_detail_head and name not in DETAIL_HEAD_MODELS:
        raise ValueError(f'Model {name} does not support detail heads.')
    nc = config.num_class
    if name == 'smp':
        return build_smp_model(config.encoder, config.decoder, nc,
                               device=device)
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
    if name == 'segnet':
        return SegNet(num_class=nc, pack_fullres=config.segnet_pack,
                      device=device)
    return _PLAIN[name](num_class=nc, device=device)


def get_teacher_model(config, device=None):
    """The frozen KD teacher (an smp model on config.teacher_encoder and
    config.teacher_decoder, uninitialized: the trainer loads
    config.teacher_ckpt), or None without kd_training."""
    if not config.kd_training:
        return None
    if config.teacher_decoder not in SMP_DECODERS:
        raise ValueError(
            f'Unsupported teacher decoder type: {config.teacher_decoder}')
    return build_smp_model(config.teacher_encoder, config.teacher_decoder,
                           config.num_class, device=device)
