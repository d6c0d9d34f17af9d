"""The orbax checkpoint bridge: JAX package checkpoints
(rtseg_tpu/train/checkpoint.py `save_train_ckpt` / `save_best_ckpt`) of
a small FastSCNN, one train step in under SGD (beta cycled by OneCycle),
Adam and AdamW, through tools/orbax_to_torch.py's `convert`
(train/checkpoint.py `from_orbax_tree`) into the port:

* the port's SegTrainer resumes the converted last checkpoint with the
  JAX state's weights, BatchNorm statistics, EMA, optimizer buffers (SGD's
  trace as momentum; Adam's mu, nu and count) and step bit for bit, and
  the meta (epoch, best score, and the optimizer added);
* one more step from each side agrees within the train-step limits of
  tests/test_torch_resnet_train.py (loss 1e-5 relative, weights 1e-4);
* the best checkpoint maps the EMA weights alone; a wrong optimizer
  type raises;
* tools/orbax_to_torch.py imports nothing of the JAX package (it needs
  orbax, so the port's import scan does not cover it).
"""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.train.checkpoint import load_meta, restore_weights
from rtseg_tpu_torch.utils.convert import (random_jax_variables,
                                           state_dict_to_flax,
                                           to_jax_variables)
from test_torch_resnet_train import PORT_ONLY, assert_trees_close

ROOT = Path(__file__).resolve().parents[1]
# the shapes of tests/test_torch_resnet_train.py (8 samples of 64x128,
# bs 4); the start of a long warmup, where Adam's rounding stays small
# (tests/test_torch_optim_tail.py says why)
KW = dict(model='fastscnn', num_class=5, dataset='synthetic', crop_h=64,
          crop_w=128, train_bs=4, val_bs=4, synthetic_len=8, total_epoch=100,
          warmup_epochs=50, lr_policy='cos_warmup', base_lr=1e-3,
          loss_type='ce', use_ema=True, compute_dtype='float32',
          random_seed=3)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool():
    spec = importlib.util.spec_from_file_location(
        'orbax_to_torch', ROOT / 'tools' / 'orbax_to_torch.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(n):
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    ds = JaxSynthetic(JaxSegConfig(**KW), mode='train')
    bs = KW['train_bs']
    return [tuple(np.stack(a) for a in zip(*(ds.get(k * bs + i)
                                             for i in range(bs))))
            for k in range(n)]


@pytest.fixture(scope='module', params=['sgd', 'adam', 'adamw'])
def jax_run(request, tmp_path_factory):
    """A JAX train state after one step, its last and best checkpoints,
    and its state after a second step on the next batch."""
    from jax.sharding import Mesh
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.checkpoint import save_best_ckpt, save_train_ckpt
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.state import TrainState
    from rtseg_tpu.train.step import build_train_step
    kind = request.param
    tmp = tmp_path_factory.mktemp(f'orbax_{kind}')
    jcfg = JaxSegConfig(**KW, optimizer_type=kind)
    jcfg.resolve(num_devices=1)
    jcfg.resolve_schedule(train_num=KW['synthetic_len'])
    opt = get_optimizer(jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]), ('data',))
    step = build_train_step(jcfg, jax_get_model(jcfg), opt, mesh)
    v = random_jax_variables(get_model(SegConfig(**KW)), seed=5)
    params = jax.tree.map(jnp.asarray, v['params'])
    stats = jax.tree.map(jnp.asarray, v['batch_stats'])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=opt.init(params),
                       ema_params=jax.tree.map(jnp.copy, params),
                       ema_batch_stats=jax.tree.map(jnp.copy, stats))
    data = _batches(2)
    state, _ = step(state, *map(jnp.asarray, data[0]))
    last, best = str(tmp / 'last.ckpt'), str(tmp / 'best.ckpt')
    save_train_ckpt(last, state, cur_epoch=1, best_score=0.25)
    save_best_ckpt(best, state, cur_epoch=1, best_score=0.25)
    one = jax.device_get(state)
    # from host arrays, as the first step was fed: the compiled step is
    # reused (the step's own outputs would compile it again)
    state, m = step(jax.tree.map(jnp.asarray, one),
                    *map(jnp.asarray, data[1]))
    return {'kind': kind, 'tmp': tmp, 'last': last, 'best': best,
            'one': one, 'two': jax.device_get(state),
            'loss': float(m['loss']), 'batch': data[1]}


def _optax_buffers(opt_state, kind):
    """{port buffer: Flax-path params tree} of an optax state."""
    from rtseg_tpu_torch.train.checkpoint import _find
    if kind == 'sgd':
        return {'momentum_buffer': _find(opt_state, ('trace',))[0]['trace']}
    adam = _find(opt_state, ('mu', 'nu'))[0]
    return {'exp_avg': adam['mu'], 'exp_avg_sq': adam['nu']}


def _as_dicts(tree):
    """An optax state as the nested dicts and lists orbax restores."""
    if hasattr(tree, '_asdict'):
        return {k: _as_dicts(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (list, tuple)):
        return [_as_dicts(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tree


def test_resume_is_bit_equal_and_the_next_step_agrees(jax_run, tmp_path):
    kind, one = jax_run['kind'], jax_run['one']
    dst = str(tmp_path / 'last.ckpt')
    meta = _tool().convert(jax_run['last'], dst, kind)
    assert meta == {'cur_epoch': 1, 'best_score': 0.25, 'kind': 'train',
                    'optimizer': kind} == load_meta(dst)
    cfg = SegConfig(**KW, **PORT_ONLY, optimizer_type=kind,
                    save_dir=str(tmp_path / 'run'), load_ckpt_path=dst,
                    resume_training=True)
    trainer = SegTrainer(cfg, device='cpu')
    assert (trainer.cur_epoch, trainer.best_score) == (1, 0.25)
    assert trainer.state.step == int(one.step) == 1
    exact = dict(tol=0.0)
    assert_trees_close(to_jax_variables(trainer.model),
                       {'params': one.params,
                        'batch_stats': one.batch_stats}, what='weights',
                       **exact)
    assert_trees_close(to_jax_variables(trainer.ema_model),
                       {'params': one.ema_params,
                        'batch_stats': one.ema_batch_stats}, what='ema',
                       **exact)
    opt = trainer.state.optimizer
    names = dict(trainer.model.named_parameters())
    for buf, tree in _optax_buffers(_as_dicts(one.opt_state), kind).items():
        got = state_dict_to_flax(
            {n: opt.state[p][buf] for n, p in names.items()}, trainer.model)
        assert_trees_close(got, {'params': tree}, what=buf, **exact)
    if kind != 'sgd':
        assert all(float(opt.state[p]['step']) == 1.0
                   for p in names.values())

    imgs, msks = jax_run['batch']
    trainer.state, m = trainer.train_step(
        trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
    assert float(m['loss']) == pytest.approx(jax_run['loss'], rel=1e-5)
    two = jax_run['two']
    assert_trees_close(to_jax_variables(trainer.model),
                       {'params': two.params,
                        'batch_stats': two.batch_stats}, 1e-4,
                       'weights after a step')
    assert_trees_close(to_jax_variables(trainer.ema_model),
                       {'params': two.ema_params,
                        'batch_stats': two.ema_batch_stats}, 1e-4,
                       'ema after a step')


def test_best_maps_the_ema_weights_alone(jax_run, tmp_path):
    """The converted best.ckpt holds the EMA weights alone; val_best()
    (from save_dir/best.ckpt) and prediction (from --load_ckpt_path)
    take them (checked once: a best checkpoint holds no optimizer)."""
    one = jax_run['one']
    ema = {'params': one.ema_params, 'batch_stats': one.ema_batch_stats}
    dst = str(tmp_path / 'run' / 'best.ckpt')
    meta = _tool().convert(jax_run['best'], dst)
    assert meta == {'kind': 'best', 'cur_epoch': 1, 'best_score': 0.25}
    model = get_model(SegConfig(**KW), device='cpu')
    restore_weights(dst, model)
    assert_trees_close(to_jax_variables(model), ema, 0.0, 'best')
    payload = torch.load(str(tmp_path / 'run' / 'best.ckpt' / 'state.pt'),
                         weights_only=True)
    assert sorted(payload) == ['variables']
    if jax_run['kind'] != 'sgd':
        return                       # weights alone: once is enough
    trainer = SegTrainer(SegConfig(**KW, **PORT_ONLY, load_ckpt=False,
                                   optimizer_type=jax_run['kind'],
                                   save_dir=str(tmp_path / 'run')),
                         device='cpu')
    assert np.isfinite(trainer.val_best())
    assert_trees_close(to_jax_variables(trainer.ema_model), ema, 0.0,
                       'val_best')
    (tmp_path / 'imgs').mkdir()
    predictor = SegTrainer(SegConfig(**KW, **PORT_ONLY, is_testing=True,
                                     test_data_folder=str(tmp_path / 'imgs'),
                                     load_ckpt_path=dst,
                                     save_dir=str(tmp_path / 'pred')),
                           device='cpu')
    assert_trees_close(to_jax_variables(predictor.predict_model), ema, 0.0,
                       'predict')


def test_a_wrong_optimizer_type_raises(jax_run, tmp_path):
    kind = jax_run['kind']
    tool = _tool()
    for other in {'sgd', 'adam', 'adamw'} - {kind}:
        with pytest.raises(ValueError, match=f'optimizer {kind!r}, not '
                                             f'{other!r}'):
            tool.convert(jax_run['last'], str(tmp_path / other), other)
    with pytest.raises(ValueError, match='name its optimizer_type'):
        tool.convert(jax_run['last'], str(tmp_path / 'none'))


def test_the_bridge_imports_nothing_of_the_jax_package():
    tree = ast.parse((ROOT / 'tools' / 'orbax_to_torch.py').read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules.add(node.module or '')
    assert 'orbax.checkpoint' in modules
    assert not {m for m in modules if m.split('.')[0] in ('rtseg_tpu', 'jax',
                                                          'flax')}
    assert any(m.startswith('rtseg_tpu_torch') for m in modules)
