"""Dataset hub and loader factories (counterpart of
rtseg_tpu/data/__init__.py)."""

from __future__ import annotations

import warnings

from ..parallel import process_count, process_index
from .cityscapes import Cityscapes
from .custom import Custom
from .loader import ShardedLoader
from .synthetic import Synthetic
from .test_folder import TestFolder

dataset_hub = {
    'cityscapes': Cityscapes,
    'custom': Custom,
    'synthetic': Synthetic,
}


def get_dataset(config):
    if config.dataset not in dataset_hub:
        raise NotImplementedError('Unsupported dataset!')
    cls = dataset_hub[config.dataset]
    return cls(config, mode='train'), cls(config, mode='val')


def _open_cache(dataset, config, pi: int, pc: int):
    """Build or open the packed cache of one split (rank 0 builds, the
    other ranks wait for its index); a dataset that cannot be packed
    (synthetic has no cache_spec) takes the decode path with a warning,
    as in the JAX package."""
    from .segpipe import CacheUnsupported, open_or_build
    try:
        return open_or_build(dataset, config.cache_dir, process_index=pi,
                             process_count=pc)
    except CacheUnsupported as e:
        warnings.warn(f'segpipe cache disabled for '
                      f'{type(dataset).__name__}: {e}', stacklevel=2)
        return None


def get_loader(config):
    """(train, val) ShardedLoaders of config.dataset; fills
    config.train_num (truncated to a multiple of the global batch: the
    train loader drops the ragged tail), val_num and the schedule.

    segpipe is wired here: the packed cache (config.segpipe_cache), the
    augment worker processes (config.aug_workers) and the raw uint8 tail
    (config.device_norm; None = on exactly where both splits' augment
    tails hand uint8 over exactly), resolved into
    config.device_norm_resolved, which tells the trainer to build its
    steps with the loader's norm_coeffs.

    In a process group (parallel/mesh.py) each rank's loaders make only its
    slice of every global batch (train_bs and val_bs are per rank), as the
    JAX package's loaders make their process's slice."""
    train_ds, val_ds = get_dataset(config)
    global_train = config.train_bs * config.gpu_num
    global_val = config.val_bs * config.gpu_num
    if len(train_ds) < global_train:
        raise ValueError(
            f'Training set ({len(train_ds)} samples) is smaller than the '
            f'global batch ({global_train}); reduce train_bs or device count.')
    config.train_num = len(train_ds) // global_train * global_train
    config.val_num = len(val_ds)
    config.resolve_schedule(config.train_num)

    pc, pi = process_count(), process_index()
    train_cache = val_cache = None
    if config.segpipe_cache:
        train_cache = _open_cache(train_ds, config, pi, pc)
        val_cache = _open_cache(val_ds, config, pi, pc)

    raw = config.device_norm
    supported = (getattr(train_ds, 'supports_raw_tail', False)
                 and getattr(val_ds, 'supports_raw_tail', False))
    if raw is None:
        raw = supported
    elif raw and not supported:
        raise ValueError(
            f'device_norm=True but the {config.dataset} augment tail has '
            f'no exact uint8 handoff (float-native samples or color '
            f'jitter enabled); set device_norm=None/False')
    config.device_norm_resolved = bool(raw)

    train_loader = ShardedLoader(
        train_ds, global_train, seed=config.random_seed, shuffle=True,
        drop_last=True, ignore_index=config.ignore_index,
        process_index=pi, process_count=pc,
        workers=config.base_workers, cache=train_cache, raw_tail=raw,
        emit_flags=True, mp_workers=config.aug_workers, tag='train')
    val_loader = ShardedLoader(
        val_ds, global_val, seed=config.random_seed, shuffle=False,
        drop_last=False, ignore_index=config.ignore_index,
        process_index=pi, process_count=pc,
        workers=config.base_workers, cache=val_cache, raw_tail=raw,
        emit_flags=False, mp_workers=config.aug_workers, tag='val')
    return train_loader, val_loader


def get_test_loader(config):
    """The test folder of prediction (reference datasets/__init__.py:52-65)
    itself: prediction reads it image by image at each image's size."""
    ds = TestFolder(config)
    config.test_num = len(ds)
    return ds


__all__ = ['Cityscapes', 'Custom', 'Synthetic', 'TestFolder', 'ShardedLoader',
           'dataset_hub', 'get_dataset', 'get_loader', 'get_test_loader']
