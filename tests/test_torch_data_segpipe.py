"""segpipe of the port (rtseg_tpu_torch/data/segpipe) against the JAX
package's: the packed cache's key and records read across the packages in
both directions, and a new key when the files or the transform change;
the augment worker processes byte-identical to the threaded path, a
worker's exception and a worker's death raised in the parent, and no
process left once the pools' helpers are shut down or the program ends;
the device prefetcher's order, errors and close on the CPU."""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.data import get_dataset as jax_get_dataset
from rtseg_tpu.data.segpipe import PackedCache as JaxPackedCache
from rtseg_tpu.data.segpipe import cache_key as jax_cache_key
from rtseg_tpu.data.segpipe import open_or_build as jax_open_or_build
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import get_dataset, get_loader
from rtseg_tpu_torch.data.loader import ShardedLoader
from rtseg_tpu_torch.data.segpipe import (CacheUnsupported, DevicePrefetcher,
                                          PackedCache, build_cache,
                                          cache_key, open_or_build,
                                          shutdown)
from torch_data_trees import Boom, cityscapes_tree, custom_tree

pytestmark = pytest.mark.filterwarnings(
    'ignore:.*fork.*:DeprecationWarning', 'ignore:.*os.fork.*:RuntimeWarning')

KW = dict(randscale=(-0.5, 1.0), h_flip=0.5, crop_size=32, train_bs=2,
          val_bs=2, num_class=19)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp('segpipe')
    return {'cityscapes': cityscapes_tree(base / 'cityscapes'),
            'custom': custom_tree(base / 'custom')}


def _datasets(kind, root, **kw):
    base = dict(KW, dataset=kind, data_root=root, **kw)
    if kind == 'custom':
        base.update(train_size=48, test_size=40)
    return (get_dataset(SegConfig(**base).resolve()),
            jax_get_dataset(JaxSegConfig(**base).resolve()))


def _same_records(cache, dataset):
    assert len(cache) == len(dataset)
    for i in range(len(dataset)):
        for a, b in zip(cache.read(i), dataset.prepare(i)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('kind', ['cityscapes', 'custom'])
def test_cache_is_read_across_packages_both_ways(trees, kind, tmp_path):
    (ours, _), (theirs, _) = _datasets(kind, trees[kind])
    assert cache_key(ours) == jax_cache_key(theirs)
    # the JAX package builds, the port reads
    jax_open_or_build(theirs, str(tmp_path / 'a'))
    before = os.listdir(tmp_path / 'a')
    cache = open_or_build(ours, str(tmp_path / 'a'))
    assert os.listdir(tmp_path / 'a') == before       # found, not rebuilt
    _same_records(cache, ours)
    # the port builds, the JAX package reads
    open_or_build(ours, str(tmp_path / 'b'))
    before = os.listdir(tmp_path / 'b')
    jcache = jax_open_or_build(theirs, str(tmp_path / 'b'))
    assert os.listdir(tmp_path / 'b') == before
    assert isinstance(jcache, JaxPackedCache)
    _same_records(jcache, ours)


def test_cache_key_changes_with_the_files_and_the_transform(tmp_path):
    root = custom_tree(tmp_path / 'custom', n_train=3, n_val=1)
    cfg = SegConfig(dataset='custom', data_root=root, train_size=48,
                    **KW).resolve()
    train, _ = get_dataset(cfg)
    key = cache_key(train)
    cache = open_or_build(train, str(tmp_path / 'c'))
    assert cache_key(get_dataset(cfg)[0]) == key
    # the transform head: another scale or square size
    for kw in (dict(scale=0.5), dict(train_size=40)):
        other = get_dataset(cfg.replace(**kw))[0]
        assert cache_key(other) != key
    # the files: a sample rewritten (a new mtime, here the same size)
    path = train.images[1]
    data = open(path, 'rb').read()
    time.sleep(0.01)
    with open(path, 'wb') as f:
        f.write(data)
    fresh = get_dataset(cfg)[0]
    assert cache_key(fresh) != key
    rebuilt = open_or_build(fresh, str(tmp_path / 'c'))
    assert rebuilt.path != cache.path
    assert len(os.listdir(tmp_path / 'c')) == 2
    _same_records(rebuilt, fresh)


def test_cache_rejects_ragged_samples_and_synthetic(tmp_path):
    class Ragged:
        def __len__(self):
            return 2

        def cache_spec(self):
            return {'ragged': True}

        def prepare(self, i):
            return (np.zeros((4 + i, 4, 3), np.uint8),
                    np.zeros((4 + i, 4), np.uint8))
    with pytest.raises(CacheUnsupported, match='fixed-shape'):
        build_cache(Ragged(), str(tmp_path / 'r'))
    assert not os.path.exists(tmp_path / 'r')
    synthetic = get_dataset(SegConfig(dataset='synthetic', **KW).resolve())
    with pytest.raises(CacheUnsupported, match='cache_spec'):
        cache_key(synthetic[0])


def test_cache_pickles_without_its_maps(trees, tmp_path):
    import pickle
    (ours, _), _ = _datasets('custom', trees['custom'])
    cache = open_or_build(ours, str(tmp_path))
    cache.read(0)
    back = pickle.loads(pickle.dumps(cache))
    assert back._maps == {}
    for a, b in zip(back.read(2), cache.read(2)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(PackedCache(cache.path), PackedCache)


def _epochs(loader, epochs=(0, 1)):
    out = []
    for ep in epochs:
        loader.set_epoch(ep)
        out.append([tuple(t.numpy() for t in b) for b in loader])
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for ba, bb in zip(ea, eb):
            assert len(ba) == len(bb)
            for xa, xb in zip(ba, bb):
                assert xa.dtype == xb.dtype
                np.testing.assert_array_equal(xa, xb)


def test_workers_are_byte_identical_to_the_threads(trees, tmp_path):
    cfg = dict(KW, dataset='cityscapes', data_root=trees['cityscapes'],
               segpipe_cache=True, save_dir=str(tmp_path))
    serial = get_loader(SegConfig(**cfg).resolve())[0]
    mp = get_loader(SegConfig(aug_workers=2, **cfg).resolve())[0]
    assert serial.raw_tail and mp.raw_tail            # auto device_norm
    _assert_same(_epochs(serial), _epochs(mp))
    # one probe and one fetch a sample, all cache hits, the probe once
    assert mp.last_cache_counts == (len(mp.dataset) + 1, 0)


def test_a_worker_exception_is_raised_in_the_parent():
    loader = ShardedLoader(Boom(), global_batch=4, shuffle=False,
                           mp_workers=2)
    with pytest.raises(ValueError, match='boom at 3'):
        list(loader)


def test_a_worker_death_is_raised_in_the_parent():
    loader = ShardedLoader(Boom(kill=True), global_batch=4, shuffle=False,
                           mp_workers=2)
    with pytest.raises(RuntimeError, match='died'):
        list(loader)


def _running(pid) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f'/proc/{pid}/stat') as f:
            stat = f.read()
    except FileNotFoundError:
        return False
    return stat[stat.rindex(')') + 2] != 'Z'


def _helper_pids():
    from multiprocessing import forkserver, resource_tracker
    return (forkserver._forkserver._forkserver_pid,
            resource_tracker._resource_tracker._pid)


def test_shutdown_stops_the_pools_helpers_and_a_pool_starts_again():
    loader = ShardedLoader(Boom(n=3), global_batch=2, shuffle=False,
                           mp_workers=2)
    first = list(loader)
    pids = _helper_pids()
    assert all(pids) and all(_running(p) for p in pids)
    shutdown()
    assert not any(_running(p) for p in pids)
    assert _helper_pids()[0] is None
    _assert_same([first], [list(loader)])
    shutdown()


def test_a_program_that_ran_a_pool_leaves_no_process(tmp_path):
    prog = tmp_path / 'prog.py'
    prog.write_text(textwrap.dedent("""
        from multiprocessing import forkserver, resource_tracker
        from rtseg_tpu_torch.data.loader import ShardedLoader
        from torch_data_trees import Boom

        if __name__ == '__main__':
            list(ShardedLoader(Boom(n=3), global_batch=2, shuffle=False,
                               mp_workers=2))
            print(forkserver._forkserver._forkserver_pid,
                  resource_tracker._resource_tracker._pid)
        """))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here]))
    out = subprocess.run([sys.executable, str(prog)], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    pids = [int(p) for p in out.stdout.split()]
    assert len(pids) == 2
    assert not [p for p in pids if _running(p)]


def test_prefetcher_keeps_order_and_stops():
    src = list(range(20))
    pf = DevicePrefetcher(iter(src), lambda x: x * 2, depth=2)
    assert list(pf) == [x * 2 for x in src]
    pf.close()                          # again after the end: no effect
    pf2 = DevicePrefetcher(iter(src), lambda x: x, depth=2)
    assert next(pf2) == 0
    pf2.close()
    assert not pf2._thread.is_alive()


def test_prefetcher_raises_the_copy_and_source_errors():
    def put(x):
        if x == 3:
            raise RuntimeError('h2d exploded')
        return x
    pf = DevicePrefetcher(iter(range(10)), put, depth=2)
    with pytest.raises(RuntimeError, match='h2d exploded'):
        list(pf)
    pf.close()

    class BadSource:
        def __iter__(self):
            raise OSError('no files')
    pf = DevicePrefetcher(BadSource(), lambda x: x, depth=1)
    with pytest.raises(OSError, match='no files'):
        next(pf)
    pf.close()


def test_prefetcher_closes_its_source():
    closed = []

    def gen():
        try:
            yield from range(100)
        finally:
            closed.append(True)

    pf = DevicePrefetcher(gen(), lambda x: x, depth=1)
    assert next(pf) == 0
    pf.close()
    assert closed == [True] and not pf._thread.is_alive()
