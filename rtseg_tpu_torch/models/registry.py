"""Model registry of the port (counterpart of rtseg_tpu/models/registry.py).

Only BiSeNetv2 is ported so far; every other name of the JAX zoo raises
NotImplementedError, and ROADMAP.md holds the order in which they come.
"""

from __future__ import annotations

from .bisenetv2 import BiSeNetv2

PORTED = ('bisenetv2',)


def get_model(config, device=None):
    """Build the port's module for config.model with parameters on
    `device` (uninitialized: load weights with utils.convert)."""
    name = config.model
    if name not in PORTED:
        raise NotImplementedError(
            f'Model {name!r} is not ported to PyTorch yet (ported: '
            f'{", ".join(PORTED)}); see ROADMAP.md Queue 1')
    return BiSeNetv2(num_class=config.num_class, use_aux=config.use_aux,
                     detail_remat=config.detail_remat,
                     pack_fullres=config.pack_fullres,
                     hires_remat=config.hires_remat,
                     s2d_stem=config.s2d_stem, device=device)
