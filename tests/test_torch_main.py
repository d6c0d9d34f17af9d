"""The slice as a whole: main_torch.py, the parser and the config files of
the port against the JAX package's.

* `load_parser` gives the JAX package's config fields on a table of
  argument lists (and refuses what it refuses); `save_config` and
  `log_config` write the JAX package's text.
* `main_torch.main(['--device', 'cpu', ...])` trains FastSCNN for an epoch
  of 2 steps on a Custom PNG tree at crop 64, writes last and best, and a
  second call resumes; without a card and without `--device cpu` it
  raises; with `--is_testing` it writes the val PNGs' masks and blends.
* The JAX SegTrainer (on a one-device mesh) and the port's, from the same
  Flax init on the same tree, both through their own get_loader and
  run(): first-epoch losses within 1e-5 (relative), weights within 1e-3
  and an equal val confusion matrix, at peak LR 1e-3.
"""

import io
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import main_torch
from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.config import load_parser as jax_load_parser
from rtseg_tpu.utils import misc as jmisc
from rtseg_tpu_torch.config import SegConfig, get_parser, load_parser
from rtseg_tpu_torch.data import png
from rtseg_tpu_torch.train.checkpoint import load_meta
from rtseg_tpu_torch.utils import misc
from rtseg_tpu_torch.utils.convert import to_jax_variables
from torch_data_trees import custom_tree

pytestmark = pytest.mark.filterwarnings(
    'ignore:.*fork.*:DeprecationWarning', 'ignore:.*os.fork.*:RuntimeWarning')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGVS = [
    [],
    ['--dataset', 'cityscapes', '--model', 'bisenetv2', '--use_aux',
     '--randscale', '-0.5', '1.0', '--brightness', '0.5', '--h_flip', '0.5',
     '--save_dir', 'save/x', '--total_epoch', '2', '--crop_size', '1024'],
    ['--randscale', '0.3', '--amp_training', '--use_tb', 'false',
     '--aux_coef', '1', '1', '0.5', '1', '--use_ema'],
    ['--amp_training', 'off', '--kd_training', '--teacher_ckpt', 't/best',
     '--kd_loss_type', 'mse', '--compute_dtype', 'float32', '--remat'],
    ['--model', 'smp', '--encoder', 'resnet18', '--decoder', 'fpn',
     '--optimizer_type', 'adamw', '--lr_policy', 'linear',
     '--class_weights', '1', '2', '3', '--val_interval', '2'],
]


@pytest.mark.parametrize('argv', ARGVS)
def test_load_parser_gives_the_jax_packages_fields(argv):
    ours = load_parser(SegConfig(dataset='cityscapes'), argv)
    theirs = jax_load_parser(JaxSegConfig(dataset='cityscapes'), argv)
    assert ours.to_dict() == theirs.to_dict()
    ours.resolve()
    theirs.resolve()
    assert ours.to_dict() == theirs.to_dict()


def test_parser_has_the_jax_packages_flags_and_refusals():
    from rtseg_tpu.config.parser import get_parser as jax_get_parser

    def flags(p):
        return {(a.dest, tuple(a.option_strings), a.nargs, a.const,
                 tuple(a.choices or ())) for a in p._actions}
    assert flags(get_parser()) == flags(jax_get_parser())
    for bad in (['--use_aux', 'true'], ['--model', 'nope'],
                ['--save_ckpt', 'maybe']):
        for load, cls in ((load_parser, SegConfig),
                          (jax_load_parser, JaxSegConfig)):
            with pytest.raises(SystemExit):
                load(cls(), bad)


def test_config_files_are_the_jax_packages(tmp_path):
    kw = dict(dataset='custom', model='fastscnn', num_class=3,
              randscale=(-0.5, 1.0), logger_name='cfg_text')
    texts = []
    for cls, mod, sub in ((SegConfig, misc, 'a'), (JaxSegConfig, jmisc, 'b')):
        cfg = cls(save_dir=str(tmp_path / 'same'), **kw).resolve()
        mod.save_config(cfg)
        saved = (tmp_path / 'same' / 'config.json').read_text()
        stream = io.StringIO()
        log = logging.getLogger(f'cfg_text_{sub}')
        log.setLevel(logging.INFO)
        log.addHandler(logging.StreamHandler(stream))
        mod.log_config(cfg, log)
        texts.append((saved, stream.getvalue()))
    assert texts[0] == texts[1]
    assert json.loads(texts[0][0])['randscale'] == [-0.5, 1.0]


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return custom_tree(tmp_path_factory.mktemp('main') / 'custom',
                       n_train=4, n_val=3, hw=(48, 60))


def _argv(tree, save_dir, epochs):
    return ['--dataset', 'custom', '--data_root', tree, '--num_class', '3',
            '--model', 'fastscnn', '--crop_size', '64', '--train_bs', '2',
            '--val_bs', '2', '--total_epoch', str(epochs), '--use_tb',
            'false', '--use_obs', 'false', '--save_dir', save_dir,
            '--compute_dtype', 'float32', '--h_flip', '0.5', '--randscale',
            '-0.5', '1.0', '--log_interval', '1']


def test_main_trains_checkpoints_and_resumes_on_the_cpu(tree, tmp_path):
    save = str(tmp_path / 'save')
    trainer, score = main_torch.main(['--device', 'cpu']
                                     + _argv(tree, save, 1))
    assert trainer.device.type == 'cpu'
    assert trainer.config.device_norm_resolved       # raw uint8 tail
    assert [s['steps'] for s in trainer.epoch_stats] == [2]
    assert np.isfinite(trainer.epoch_losses).all() and 0 <= score <= 1
    for name in ('last.ckpt', 'best.ckpt', 'config.json'):
        assert os.path.exists(os.path.join(save, name)), name
    assert load_meta(os.path.join(save, 'last.ckpt'))['cur_epoch'] == 1
    resumed, _ = main_torch.main(['--device=cpu'] + _argv(tree, save, 2))
    assert len(resumed.epoch_losses) == 1           # epoch 2 alone
    assert load_meta(os.path.join(save, 'last.ckpt'))['cur_epoch'] == 2


def test_main_needs_a_card_or_the_cpu_named(tree, tmp_path, monkeypatch):
    assert main_torch.split_device(['--device', 'cpu', '--model', 'x']) \
        == ('cpu', ['--model', 'x'])
    assert main_torch.split_device(['--model', 'x']) == (None,
                                                         ['--model', 'x'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main_torch.main(_argv(tree, str(tmp_path / 's'), 1))
    # --is_testing predicts: the val PNGs' masks and blends
    trainer, score = main_torch.main(
        ['--device', 'cpu', '--is_testing', '--test_data_folder',
         os.path.join(tree, 'val', 'imgs')]
        + _argv(tree, str(tmp_path / 's'), 1))
    assert score is None and trainer.device.type == 'cpu'
    for sub in ('predicts', 'predicts_blend'):
        names = sorted(os.listdir(tmp_path / 's' / sub))
        assert len(names) == 3, names
        assert png.read(str(tmp_path / 's' / sub / names[0]),
                        'RGB').shape == (48, 60, 3)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_port_trainer_follows_the_jax_trainer(tree, tmp_path, monkeypatch):
    from rtseg_tpu.parallel import make_mesh
    from rtseg_tpu.train import trainer as jax_trainer_mod
    from rtseg_tpu_torch.train import SegTrainer

    monkeypatch.setattr(jax_trainer_mod, 'make_mesh',
                        lambda **kw: make_mesh(num_devices=1, **kw))
    kw = dict(dataset='custom', data_root=tree, num_class=3,
              model='fastscnn', crop_size=64, train_bs=2, val_bs=2,
              total_epoch=1, base_lr=1e-3,
              compute_dtype='float32', use_tb=False, use_obs=False,
              h_flip=0.5, randscale=(-0.5, 1.0), log_interval=0)
    jcfg = JaxSegConfig(save_dir=str(tmp_path / 'jax'), **kw)
    jtrainer = jax_trainer_mod.SegTrainer(jcfg)
    variables = jax.device_get({'params': jtrainer.state.params,
                                'batch_stats': jtrainer.state.batch_stats})
    jtrainer.run()
    trainer = SegTrainer(SegConfig(save_dir=str(tmp_path / 'port'), **kw),
                         device='cpu', variables=variables)
    trainer.run()
    assert trainer.config.iters_per_epoch == jcfg.iters_per_epoch == 2
    rel = abs(trainer.epoch_losses[0] - jtrainer.epoch_losses[0]) \
        / abs(jtrainer.epoch_losses[0])
    assert rel <= 1e-5, (trainer.epoch_losses, jtrainer.epoch_losses)
    want = dict(_flat(jax.device_get({
        'params': jtrainer.state.params,
        'batch_stats': jtrainer.state.batch_stats})))
    got = dict(_flat(to_jax_variables(trainer.model)))
    assert got.keys() == want.keys()
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    assert worst <= 1e-3, worst
    # the val confusion matrix of both EMA models (best.ckpt's, restored
    # by val_best)
    jcm = sum(np.asarray(jtrainer.eval_step(jtrainer.state, *b), np.int64)
              for b in jtrainer._batches(jtrainer.val_loader))
    np.testing.assert_array_equal(trainer.last_cm, jcm)
    assert trainer.last_cm.sum() == 3 * 48 * 60     # every val pixel
