"""Loss factory (counterpart of rtseg_tpu/losses/__init__.py). Ported:
cross-entropy, OHEM cross-entropy, and the STDC detail loss with
`laplacian_pyramid`. The KD loss comes with KD (ROADMAP.md Queue 1 item
4)."""

from .losses import (bce_with_logits, cross_entropy, detail_loss, dice_loss,
                     laplacian_pyramid, ohem_cross_entropy)


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


def get_detail_loss_fn(config):
    """loss(detail logits, binary targets): dice + BCE weighted by
    config.dice_loss_coef and config.bce_loss_coef."""
    def fn(logits, targets):
        return detail_loss(logits, targets, config.dice_loss_coef,
                           config.bce_loss_coef)
    return fn


__all__ = ['bce_with_logits', 'cross_entropy', 'detail_loss', 'dice_loss',
           'laplacian_pyramid', 'ohem_cross_entropy', 'get_loss_fn',
           'get_detail_loss_fn']
