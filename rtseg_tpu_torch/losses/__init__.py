"""Loss factory (counterpart of rtseg_tpu/losses/__init__.py):
cross-entropy, OHEM cross-entropy, the STDC detail loss with
`laplacian_pyramid`, and the KD loss."""

from .losses import (bce_with_logits, cross_entropy, detail_loss, dice_loss,
                     kd_loss, laplacian_pyramid, ohem_cross_entropy)


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


def get_kd_loss_fn(config):
    """loss(student logits, teacher logits) for config.kd_loss_type at
    config.kd_temperature."""
    def fn(student_logits, teacher_logits):
        return kd_loss(student_logits, teacher_logits, config.kd_loss_type,
                       config.kd_temperature)
    return fn


__all__ = ['bce_with_logits', 'cross_entropy', 'detail_loss', 'dice_loss',
           'kd_loss', 'laplacian_pyramid', 'ohem_cross_entropy',
           'get_loss_fn', 'get_detail_loss_fn', 'get_kd_loss_fn']
