"""The port's process groups (rtseg_tpu_torch/parallel/) and each rank's
loader against the JAX package's, on the CPU.

Ranks are spawned processes (tests/_torch_ddp_worker.py) that open their
group through `init_multihost`, once from the torchrun environment
(env://) and once from `multihost` with a coordinator (tcp://), on a port
found free at run time; in a world of 2, prediction (is_testing)
raises, and each process resolves the card main_torch.py's `--device
cuda:K` gives it; two multihost processes of one host open NCCL each on
its own card (the card's calls recorded). `multihost=True` without its
coordinator fields raises (F4).
The world size resolves gpu_num, the LR and the schedule as the JAX
package's `resolve(num_devices=N)` / `resolve_schedule`. Each
rank's loaders from `get_loader` in a world of 2 and 4 give the batches of
the JAX package's `get_loader` for that process index, bit for bit, over
2 epochs of a Cityscapes PNG tree with shuffle and jitter.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_ddp_worker as ddp
from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.parallel import (all_reduce_mean, all_reduce_sum,
                                      average_, barrier, init_multihost,
                                      is_distributed, local_device,
                                      main_rank, process_count,
                                      process_index)
from torch_data_trees import cityscapes_tree


@pytest.mark.parametrize('how', ['torchrun', 'multihost'])
def test_two_ranks_rendezvous(tmp_path, how):
    port = ddp.free_port()
    envs = None
    if how == 'torchrun':
        envs = [dict(RANK=str(r), WORLD_SIZE='2', LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE='2', MASTER_ADDR='127.0.0.1',
                     MASTER_PORT=str(port)) for r in range(2)]
    got = ddp.run('rendezvous', 2, tmp_path, envs=envs, how=how, port=port,
                  timeout=120)
    for rank, g in enumerate(got):
        assert g['opened'] and not g['again']     # a group is opened once
        assert (g['count'], g['index'], g['main']) == (2, rank, rank == 0)
        assert g['backend'] == 'gloo' and g['total'] == 3
        assert g['mean'] == 0.5
        assert 'prediction (is_testing) runs in one process' in \
            g['predict_refused']
    # LOCAL_RANK names the card of a launcher's rank
    assert [g['device'] for g in got] == (
        ['cuda:0', 'cuda:1'] if how == 'torchrun' else ['cuda:0', 'cuda:0'])
    # processes sharing a host each resolve the card they were given
    assert [g['given'] for g in got] == ['cuda:0', 'cuda:1']


def test_multihost_processes_on_one_host_open_nccl_on_their_own_card(
        monkeypatch):
    """Two --multihost processes of one host, each given its card with
    main_torch.py's `--device cuda:K` (LOCAL_RANK unset): each sets its
    own card and opens NCCL as its process id (the card's calls recorded,
    nothing opened)."""
    import main_torch
    import torch.distributed as dist
    monkeypatch.delenv('LOCAL_RANK', raising=False)
    calls = []
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: calls.append(('set_device', str(d))))
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda *a, **kw: calls.append((a, kw)))
    for rank in range(2):
        device, rest = main_torch.split_device(
            ['--device', f'cuda:{rank}', '--model', 'x'])
        assert rest == ['--model', 'x']
        cfg = SegConfig(multihost=True, coordinator_address='h:29500',
                        process_id=rank, num_processes=2)
        assert init_multihost(cfg, local_device(device))
        assert calls[-2:] == [
            ('set_device', f'cuda:{rank}'),
            (('nccl',), dict(init_method='tcp://h:29500', rank=rank,
                             world_size=2))]
    assert not is_distributed()
    for bad in ('gpu', 'cuda:', 'cuda:x', 'cpu:0'):
        with pytest.raises(SystemExit):
            main_torch.split_device(['--device', bad])


def test_without_a_world_nothing_opens_and_nothing_is_issued(monkeypatch):
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    assert not init_multihost(SegConfig(), 'cpu')
    assert not is_distributed()
    assert (process_count(), process_index(), main_rank()) == (1, 0, True)
    t = torch.tensor([1.5, 2.5])
    assert all_reduce_sum(t) is t and all_reduce_mean(t) is t
    average_([t])
    barrier()
    assert t.tolist() == [1.5, 2.5]
    assert local_device() == torch.device('cuda', 0)
    assert local_device('cpu') == torch.device('cpu')
    assert local_device('cuda:3') == torch.device('cuda', 3)
    monkeypatch.setenv('LOCAL_RANK', '2')
    assert local_device('cuda') == torch.device('cuda', 2)


@pytest.mark.parametrize('fields', [
    dict(multihost=True),
    dict(multihost=True, coordinator_address='127.0.0.1:1'),
    dict(multihost=True, coordinator_address='127.0.0.1:1', process_id=0),
    dict(coordinator_address='127.0.0.1:1'),
    dict(process_id=1, num_processes=2)])
def test_multihost_fields_open_the_group_or_raise(fields):
    """F4: the multihost switch and its coordinator fields are never
    ignored: a field missing under multihost, or set without it, raises
    before anything is opened."""
    with pytest.raises(ValueError, match='multihost'):
        init_multihost(SegConfig(**fields), 'cpu')
    assert not is_distributed()


def test_the_trainer_refuses_the_fields_as_init_multihost(tmp_path):
    from rtseg_tpu_torch.train import SegTrainer
    with pytest.raises(ValueError, match='num_processes'):
        SegTrainer(SegConfig(multihost=True, coordinator_address='h:1',
                             process_id=0, save_dir=str(tmp_path)),
                   device='cpu')


@pytest.mark.parametrize('world', [1, 2, 4])
@pytest.mark.parametrize('optimizer', ['sgd', 'adamw'])
def test_world_size_resolves_as_the_jax_mesh_size(world, optimizer):
    kw = dict(optimizer_type=optimizer, base_lr=0.02, train_bs=3,
              total_epoch=7)
    cfg = SegConfig(**kw).resolve(num_devices=world)
    jcfg = JaxSegConfig(**kw).resolve(num_devices=world)
    cfg.resolve_schedule(100)
    jcfg.resolve_schedule(100)
    for f in ('gpu_num', 'lr', 'iters_per_epoch', 'total_itrs'):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.gpu_num == world
    assert cfg.lr == (0.02 if optimizer == 'sgd' else 0.001) * world


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    # 9 train and 5 val samples: a dropped train tail, a val tail that
    # leaves some ranks an empty slice
    return cityscapes_tree(tmp_path_factory.mktemp('ranks') / 'cs',
                           n_train=9, n_val=5)


def _config(cls, root, save_dir, world):
    jitter = dict(brightness=0.5, contrast=0.5, saturation=0.5,
                  randscale=(-0.5, 1.0), h_flip=0.5)
    kw = dict(dataset='cityscapes', data_root=root, num_class=19,
              crop_size=32, train_bs=1, val_bs=1, total_epoch=3,
              random_seed=5, base_workers=0, device_norm=False,
              save_dir=save_dir, **jitter)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kw.items() if k in names}).resolve(
        num_devices=world)


@pytest.mark.parametrize('world', [2, 4])
def test_each_rank_loads_the_jax_process_slice(tree, tmp_path, monkeypatch,
                                               world):
    """get_loader on rank r of a world of N (the group's rank and size)
    against the JAX package's get_loader as process r of N: train_num,
    the schedule and every batch of train and val, 2 epochs."""
    import jax
    from rtseg_tpu.data import get_loader as jax_get_loader
    from rtseg_tpu_torch import data as port_data
    for rank in range(world):
        monkeypatch.setattr(port_data, 'process_count', lambda: world)
        monkeypatch.setattr(port_data, 'process_index', lambda: rank)
        monkeypatch.setattr(jax, 'process_count', lambda: world)
        monkeypatch.setattr(jax, 'process_index', lambda: rank)
        cfg = _config(SegConfig, tree, str(tmp_path / 'p'), world)
        jcfg = _config(JaxSegConfig, tree, str(tmp_path / 'j'), world)
        ours, theirs = port_data.get_loader(cfg), jax_get_loader(jcfg)
        for f in ('train_num', 'val_num', 'iters_per_epoch', 'total_itrs'):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        for o, t in zip(ours, theirs):
            assert (o.process_index, o.process_count) == (rank, world)
            assert (t.process_index, t.process_count) == (rank, world)
            for epoch in (0, 1):
                o.set_epoch(epoch)
                t.set_epoch(epoch)
                got, want = list(o), list(t)
                assert len(got) == len(want) == len(o)
                for bg, bw in zip(got, want):
                    assert len(bg) == len(bw) == 2
                    for a, b in zip(bg, bw):
                        a, b = a.numpy(), np.asarray(b)
                        assert a.dtype == b.dtype and a.shape == b.shape
                        np.testing.assert_array_equal(a, b)
        # 9 train samples: global batches of N; 5 val samples padded
        assert len(ours[0]) == 9 // world and len(ours[1]) == -(-5 // world)
