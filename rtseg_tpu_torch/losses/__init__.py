"""Loss factory (counterpart of rtseg_tpu/losses/__init__.py). Ported:
cross-entropy and OHEM cross-entropy. The dice, detail and KD losses and
`laplacian_pyramid` come with STDC and KD (ROADMAP.md Queue 1 item 4)."""

from .losses import cross_entropy, ohem_cross_entropy


def get_loss_fn(config):
    """loss(logits, labels) for config.loss_type ('ce' or 'ohem')."""
    weights = config.class_weights
    if config.loss_type == 'ce':
        def fn(logits, labels):
            return cross_entropy(logits, labels, config.ignore_index,
                                 weights, config.reduction)
    elif config.loss_type == 'ohem':
        def fn(logits, labels):
            return ohem_cross_entropy(logits, labels, config.ohem_thrs,
                                      ignore_index=config.ignore_index)
    else:
        raise NotImplementedError(f'Unsupported loss type: {config.loss_type}')
    return fn


__all__ = ['cross_entropy', 'ohem_cross_entropy', 'get_loss_fn']
