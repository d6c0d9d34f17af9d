"""Loader factories (counterpart of rtseg_tpu/data/__init__.py). Only the
synthetic dataset is ported (see ROADMAP.md Queue 1, "Trainer, checkpoint and
data")."""

from ..config import refuse_unported
from .loader import BatchLoader, check_dataset, get_val_loader
from .synthetic import Synthetic

# segpipe's switches of the JAX loader, which the port does not implement
# yet (config.refuse_unported)
_NOT_PORTED = (
    ('segpipe_cache', bool, 'the packed sample cache',
     'Trainer, checkpoint and data'),
    ('aug_workers', lambda v: v > 0, 'the process augment workers',
     'Trainer, checkpoint and data'))


def get_loader(config, pin_memory: bool = False):
    """(train, val) loaders of config.dataset. train_num is truncated to a
    multiple of the batch (the loader drops the ragged tail), then the
    schedule is resolved from it (config.resolve_schedule).

    config.device_norm (the raw uint8 tail; None = on exactly where both
    splits' augment tails hand uint8 over exactly) resolves, as in the JAX
    package, into config.device_norm_resolved, which tells the trainer to
    build its steps with the loader's norm_coeffs. No ported dataset has
    the raw tail: None resolves to False and True raises the JAX
    package's ValueError."""
    check_dataset(config)
    refuse_unported(config, _NOT_PORTED)
    train_ds = Synthetic(config, mode='train')
    if len(train_ds) < config.train_bs:
        raise ValueError(
            f'Training set ({len(train_ds)} samples) is smaller than the '
            f'batch ({config.train_bs}); reduce train_bs.')
    config.train_num = len(train_ds) // config.train_bs * config.train_bs
    config.resolve_schedule(config.train_num)
    train_loader = BatchLoader(
        train_ds, config.train_bs, seed=config.random_seed, shuffle=True,
        drop_last=True, ignore_index=config.ignore_index,
        pin_memory=pin_memory, workers=config.base_workers)
    val_loader = get_val_loader(config, pin_memory)
    raw = config.device_norm
    supported = (train_ds.supports_raw_tail
                 and val_loader.dataset.supports_raw_tail)
    if raw is None:
        raw = supported
    elif raw and not supported:
        raise ValueError(
            f'device_norm=True but the {config.dataset} augment tail has '
            f'no exact uint8 handoff (float-native samples or color '
            f'jitter enabled); set device_norm=None/False')
    config.device_norm_resolved = bool(raw)
    return train_loader, val_loader


__all__ = ['BatchLoader', 'get_loader', 'get_val_loader', 'Synthetic']
