"""Loader factories (counterpart of rtseg_tpu/data/__init__.py). Only the
synthetic dataset is ported (see ROADMAP.md Queue 1, "Trainer, checkpoint and
data")."""

from .loader import BatchLoader, check_dataset, get_val_loader
from .synthetic import Synthetic


def get_loader(config, pin_memory: bool = False):
    """(train, val) loaders of config.dataset. train_num is truncated to a
    multiple of the batch (the loader drops the ragged tail), then the
    schedule is resolved from it (config.resolve_schedule)."""
    check_dataset(config)
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
    return train_loader, get_val_loader(config, pin_memory)


__all__ = ['BatchLoader', 'get_loader', 'get_val_loader', 'Synthetic']
