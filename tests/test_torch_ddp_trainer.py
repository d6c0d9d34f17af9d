"""SegTrainer and main_torch.py on 2 gloo ranks against the JAX package's
SegTrainer on a 2-device `('data',)` mesh, on the CPU.

FastSCNN in float32 on synthetic data (2 ranks x 2 samples a step, 2
steps an epoch, 4 val batches of 2 a rank, peak LR 2e-3): `run()` for one
epoch on spawned ranks (tests/_torch_ddp_worker.py) against the JAX
trainer with `make_mesh` patched to 2 devices (as tests/test_torch_main.py
patches it to 1), from the same Flax init: the epoch loss within 1e-5
relative, the weights within 1e-3, gpu_num, the LR and the schedule
equal, and the ranks' summed val confusion matrix (val_best's) equal to
the JAX eval step's on its val_best weights; a one-process validate of
rank 0's weights gives it bit for bit. Then a fresh trainer on each rank
resumes last.ckpt for a second epoch, from the first run's weights
exactly. Rank 0 alone writes the checkpoints, and the ranks end with
equal weights. main_torch.main under a launcher's environment trains 2
ranks.
"""

import numpy as np
import pytest
import torch

import _torch_ddp_worker as ddp
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.train import SegTrainer

WORLD = 2
KW = dict(dataset='synthetic', model='fastscnn', num_class=5, crop_size=64,
          train_bs=2, val_bs=2, synthetic_len=8, base_lr=1e-3,
          compute_dtype='float32', use_tb=False, use_obs=False,
          log_interval=1, random_seed=2)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.parallel import make_mesh
    from rtseg_tpu.train import trainer as jax_trainer_mod
    tmp = tmp_path_factory.mktemp('ddp_trainer')
    jcfg = JaxSegConfig(save_dir=str(tmp / 'jax'), total_epoch=1, **KW)
    real = jax_trainer_mod.make_mesh
    jax_trainer_mod.make_mesh = lambda **kw: real(num_devices=WORLD, **kw)
    try:
        jtrainer = jax_trainer_mod.SegTrainer(jcfg)
        variables = jax.device_get({
            'params': jtrainer.state.params,
            'batch_stats': jtrainer.state.batch_stats})
        port = ddp.start('ddp_trainer', WORLD, tmp,
                         kw=dict(KW, save_dir=str(tmp / 'port')),
                         variables=variables, epochs=(1, 2))
        master = str(ddp.free_port())
        argv = ['--device', 'cpu', '--dataset', 'synthetic', '--model',
                'fastscnn', '--num_class', '3', '--crop_size', '32',
                '--train_bs', '4', '--val_bs', '4', '--total_epoch', '1',
                '--compute_dtype', 'float32', '--use_tb', 'false',
                '--use_obs', 'false', '--save_dir', str(tmp / 'main')]
        envs = [dict(RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                     MASTER_ADDR='127.0.0.1', MASTER_PORT=master)
                for r in range(WORLD)]
        main_ranks = ddp.start('main_torch_run', WORLD, tmp, envs=envs,
                               argv=argv)
        jscore = jtrainer.run()
        jcm = sum(np.asarray(jtrainer.eval_step(jtrainer.state, *b),
                             np.int64)
                  for b in jtrainer._batches(jtrainer.val_loader))
        jax_out = dict(losses=jtrainer.epoch_losses, score=jscore, cm=jcm,
                       gpu_num=jcfg.gpu_num, lr=jcfg.lr,
                       total_itrs=jcfg.total_itrs,
                       model=jax.device_get(
                           {'params': jtrainer.state.params,
                            'batch_stats': jtrainer.state.batch_stats}))
    finally:
        jax_trainer_mod.make_mesh = real
    return dict(jax=jax_out, port=port.results(), main=main_ranks.results(),
                dir=tmp / 'port')


def test_two_ranks_follow_the_jax_two_device_trainer(runs):
    j = runs['jax']
    for rank, r in enumerate(runs['port']):
        first = r['runs'][0]
        assert first['start'] == 0 and first['step'] == 2
        for f in ('gpu_num', 'lr', 'total_itrs'):
            assert first[f] == j[f], f
        assert first['gpu_num'] == WORLD and first['total_itrs'] == 2
        np.testing.assert_allclose(first['losses'], j['losses'], rtol=1e-5)
        want = dict(_leaves(j['model']))
        got = dict(_leaves(first['model']))
        assert got.keys() == want.keys()
        worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
        assert worst <= 1e-3, (rank, worst)
        # val_best's matrix: the ranks' sum, every val pixel counted once
        np.testing.assert_array_equal(first['cm'], j['cm'])
        assert first['cm'].sum() == 16 * 64 * 64
        assert first['score'] == pytest.approx(j['score'], abs=1e-12)


def test_a_fresh_trainer_on_each_rank_resumes_the_last_checkpoint(runs):
    for r in runs['port']:
        first, resumed = r['runs']
        assert resumed['start'] == 1 and resumed['step'] == 4
        assert resumed['total_itrs'] == 4 and len(resumed['losses']) == 1
        assert np.isfinite(resumed['losses'][0])
        for (k, x), (_, y) in zip(_leaves(first['model']),
                                  _leaves(resumed['start_model'])):
            np.testing.assert_array_equal(x, y, err_msg=str(k))


def test_rank_zero_alone_writes_and_the_ranks_stay_equal(runs):
    r0, r1 = runs['port']
    # a last.ckpt an epoch of each run; best.ckpt where the mIoU rose
    assert r0['writes'].count('write_train_ckpt') == 2
    assert r0['writes'].count('write_best_ckpt') >= 1
    assert r1['writes'] == []
    assert (runs['dir'] / 'last.ckpt' / 'state.pt').exists()
    assert (runs['dir'] / 'best.ckpt' / 'state.pt').exists()
    for a, b in zip(r0['runs'], r1['runs']):
        assert a['losses'] == b['losses'] and a['history'] == b['history']
        assert a['best'] == b['best']
        np.testing.assert_array_equal(a['cm'], b['cm'])
        for what in ('model', 'ema'):
            for (k, x), (_, y) in zip(_leaves(a[what]), _leaves(b[what])):
                np.testing.assert_array_equal(x, y, err_msg=str(k))


def test_summed_matrix_is_one_process_validate_bit_for_bit(runs, tmp_path):
    """A one-process trainer with rank 0's EMA weights (val_best's) and
    the same per-call batch validates the same matrix."""
    first = runs['port'][0]['runs'][0]
    one = SegTrainer(SegConfig(**KW, save_dir=str(tmp_path), load_ckpt=False,
                               total_epoch=1),
                     device='cpu', variables=first['ema'])
    one.validate()
    np.testing.assert_array_equal(one.last_cm, first['cm'])


def test_main_torch_under_a_launcher_trains_two_ranks(runs):
    for rank, r in enumerate(runs['main']):
        assert (r['count'], r['index']) == (WORLD, rank)
        assert r['train_loader'] == (rank, WORLD)
        assert r['device'] == 'cpu' and r['gpu_num'] == WORLD
        # 64 synthetic samples, a global batch of 8
        assert r['step'] == 8 and len(r['losses']) == 1
        assert np.isfinite(r['losses'][0]) and np.isfinite(r['score'])
    assert runs['main'][0]['losses'] == runs['main'][1]['losses']
