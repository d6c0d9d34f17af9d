"""The port's whole host data path against the JAX package's:
`rtseg_tpu_torch.data.get_loader` batches bit-equal to
`rtseg_tpu.data.get_loader` batches over 2 epochs of train and val, on
Cityscapes and Custom PNG trees, with the float tail (color jitter on) and
the raw uint8 tail (flip flags included), the packed cache on and off, and
0 and 2 augment worker processes; train_num, val_num, the schedule and
device_norm_resolved equal. Also the dummy batch of an empty slice and
the padded last val batch."""

import numpy as np
import pytest
import torch

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.data import get_loader as jax_get_loader
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import get_loader
from rtseg_tpu_torch.data.loader import ShardedLoader
from torch_data_trees import cityscapes_tree, custom_tree

pytestmark = pytest.mark.filterwarnings(
    'ignore:.*fork.*:DeprecationWarning', 'ignore:.*os.fork.*:RuntimeWarning')

TAILS = {'float': dict(device_norm=False, brightness=0.5, contrast=0.5,
                       saturation=0.5),
         'raw': dict(device_norm=None)}


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp('loader')
    # 7 and 5 samples: a dropped train tail and a padded val tail
    return {'cityscapes': cityscapes_tree(base / 'cityscapes', n_train=7,
                                          n_val=5),
            'custom': custom_tree(base / 'custom', n_train=7, n_val=5)}


def _config(cls, kind, root, save_dir, tail, cache, workers):
    kw = dict(dataset=kind, data_root=root, num_class=19, crop_size=32,
              randscale=(-0.5, 1.0), h_flip=0.5, train_bs=2, val_bs=2,
              total_epoch=3, random_seed=5, base_workers=2,
              segpipe_cache=cache, aug_workers=workers, save_dir=save_dir,
              **TAILS[tail])
    if kind == 'custom':
        kw.update(num_class=3, train_size=48, test_size=40)
    return cls(**kw).resolve(num_devices=1)


def _epochs(loaders, to_numpy):
    out = []
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
            out.append([tuple(to_numpy(t) for t in b) for b in loader])
    return out


@pytest.mark.parametrize('kind', ['cityscapes', 'custom'])
@pytest.mark.parametrize('tail', ['float', 'raw'])
@pytest.mark.parametrize('cache', [False, True])
@pytest.mark.parametrize('workers', [0, 2])
def test_batches_equal_the_jax_loaders(trees, tmp_path, kind, tail, cache,
                                       workers):
    cfg = _config(SegConfig, kind, trees[kind], str(tmp_path / 'port'),
                  tail, cache, workers)
    jcfg = _config(JaxSegConfig, kind, trees[kind], str(tmp_path / 'jax'),
                   tail, cache, workers)
    ours, theirs = get_loader(cfg), jax_get_loader(jcfg)
    for f in ('train_num', 'val_num', 'iters_per_epoch', 'total_itrs',
              'device_norm_resolved'):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.train_num, cfg.val_num) == (6, 5)
    assert cfg.device_norm_resolved == (tail == 'raw')
    got = _epochs(ours, lambda t: t.numpy())
    want = _epochs(theirs, np.asarray)
    assert [len(e) for e in got] == [3, 3, 3, 3]
    for e_got, e_want in zip(got, want):
        for b_got, b_want in zip(e_got, e_want):
            assert len(b_got) == len(b_want)
            for a, b in zip(b_got, b_want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    train, val = got[0], got[1]
    assert len(train[0]) == (3 if tail == 'raw' else 2)  # flags on train
    assert len(val[0]) == 2
    assert train[0][0].dtype == (np.uint8 if tail == 'raw' else np.float32)
    assert (val[-1][1][1:] == 255).all()           # the padded val tail
    assert ours[0].norm_coeffs is not None if tail == 'raw' \
        else ours[0].norm_coeffs is None


def test_empty_slice_gets_one_all_ignored_batch_an_epoch():
    class Counting:
        zero = 0

        def __len__(self):
            return 6

        def get(self, i, rng):
            if i == 0:
                Counting.zero += 1
            return (np.full((4, 4, 3), i, np.float32),
                    np.full((4, 4), i, np.int32))
    loader = ShardedLoader(Counting(), global_batch=4, shuffle=False,
                           drop_last=False, process_index=1, process_count=2)
    for _ in range(2):
        batches = list(loader)
        assert len(batches) == 2
        imgs, masks = batches[1]                  # this slice is empty
        assert isinstance(masks, torch.Tensor) and (masks == 255).all()
        assert imgs.shape[0] == loader.local_batch
    assert Counting.zero == 1
