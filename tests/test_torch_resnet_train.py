"""PyTorch port against the JAX package: training and validation of the
backbone family (BiSeNetv1, ICNet with its aux heads) through the port's
train step and SegTrainer, on the CPU. One train step of each of the other
six models, and the validation of the full-resolution models, are in
tests/test_torch_resnet_train_steps.py.

The same seeded Flax-shaped variables (made with numpy by the port) start
both packages; the same synthetic batches drive the JAX build_train_step
and build_eval_step on a one-device mesh and the port. Each JAX step is
compiled once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.utils.convert import (_flatten, random_jax_variables,
                                           to_jax_variables)

NC, H, W, BS = 19, 64, 128, 4
# 12 train samples: 3 steps an epoch, the third at the peak LR of 1e-3
# (tests/test_torch_zoo_train.py says why not the default 1e-2); 16 val
# samples at bs 8
KW = dict(num_class=NC, dataset='synthetic', crop_h=H, crop_w=W,
          train_bs=BS, val_bs=8, synthetic_len=12, total_epoch=2,
          warmup_epochs=1, lr_policy='cos_warmup', base_lr=1e-3,
          optimizer_type='sgd', loss_type='ce', use_ema=True,
          compute_dtype='float32', random_seed=3, use_aux=False)
VARIANTS = {
    'bisenetv1': dict(model='bisenetv1'),
    'icnet_aux': dict(model='icnet', use_aux=True, loss_type='ohem'),
    'icnet': dict(model='icnet'),
    'swiftnet': dict(model='swiftnet'),
    'farseenet': dict(model='farseenet'),
    'shelfnet': dict(model='shelfnet'),
    'linknet': dict(model='linknet'),
    'liteseg': dict(model='liteseg'),
    'canet': dict(model='canet'),
    # PP-LiteSeg and the InitialBlock-stem models
    # (tests/test_torch_ppliteseg.py, tests/test_torch_stem_train*.py)
    'ppliteseg': dict(model='ppliteseg'),
    'cfpnet': dict(model='cfpnet'),
    'dabnet': dict(model='dabnet'),
    'mininetv2': dict(model='mininetv2'),
    'erfnet': dict(model='erfnet'),
    'esnet': dict(model='esnet'),
    'fddwnet': dict(model='fddwnet'),
    'fssnet': dict(model='fssnet'),
}
PORT_ONLY = dict(use_tb=False, use_obs=False, base_workers=0)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(variant):
    return {**KW, **VARIANTS[variant]}


def port_config(variant, save_dir, **kw):
    return SegConfig(**{**_kw(variant), **PORT_ONLY,
                        'save_dir': str(save_dir), **kw})


def jax_config(variant, **kw):
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    jcfg = JaxSegConfig(**{**_kw(variant), **kw})
    jcfg.resolve(num_devices=1)
    return jcfg


def variables(variant):
    return random_jax_variables(get_model(SegConfig(**_kw(variant))),
                                seed=list(VARIANTS).index(variant))


def _mesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ('data',))


def jax_state(variables, opt=None):
    from rtseg_tpu.train.state import TrainState
    params = jax.tree.map(jnp.asarray, variables['params'])
    stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats,
                      opt_state=opt.init(params) if opt else (),
                      ema_params=jax.tree.map(jnp.copy, params),
                      ema_batch_stats=jax.tree.map(jnp.copy, stats))


def batches(variant, n):
    """n train batches of BS distinct synthetic samples (the JAX
    package's own dataset)."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    ds = JaxSynthetic(JaxSegConfig(**_kw(variant)), mode='train')
    return [tuple(np.stack(a) for a in zip(*(ds.get(k * BS + i)
                                             for i in range(BS))))
            for k in range(n)]


def assert_trees_close(got, want, tol, what):
    """Every leaf within tol, as np.allclose(atol=tol, rtol=tol)."""
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert got.keys() == want.keys(), what
    worst = max((float((np.abs(got[k] - want[k])
                        - tol * np.abs(want[k])).max()), k) for k in got)
    assert worst[0] <= tol, (what, worst)


def run_steps(variant, n, tmp_path):
    """(JAX losses, JAX state, port losses, port trainer) after n float32
    steps from the same variables on the same batches."""
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.step import build_train_step as jax_train_step
    v = variables(variant)
    jcfg = jax_config(variant)
    jcfg.resolve_schedule(train_num=KW['synthetic_len'])
    opt = get_optimizer(jcfg)
    step = jax_train_step(jcfg, jax_get_model(jcfg), opt, _mesh())
    state = jax_state(v, opt)
    data = batches(variant, n)
    jlosses = []
    for imgs, msks in data:
        state, m = step(state, jnp.asarray(imgs), jnp.asarray(msks))
        assert set(m) == {'loss'}
        jlosses.append(float(m['loss']))
    jstate = jax.device_get(
        {'variables': {'params': state.params,
                       'batch_stats': state.batch_stats},
         'ema': {'params': state.ema_params,
                 'batch_stats': state.ema_batch_stats}})
    trainer = SegTrainer(port_config(variant, tmp_path), device='cpu',
                         variables=v)
    tlosses = []
    for imgs, msks in data:
        trainer.state, m = trainer.train_step(
            trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
        assert set(m) == {'loss'}
        tlosses.append(float(m['loss']))
    return jlosses, jstate, tlosses, trainer


def check_steps(variant, n, tmp_path, tol=1e-4):
    """Each step's loss within 1e-5 relative of the JAX step's; params,
    batch_stats and their EMA within `tol`."""
    jlosses, jstate, tlosses, trainer = run_steps(variant, n, tmp_path)
    assert trainer.state.step == n
    assert tlosses == pytest.approx(jlosses, rel=1e-5)
    assert_trees_close(to_jax_variables(trainer.model), jstate['variables'],
                       tol, 'params/batch_stats')
    assert_trees_close(to_jax_variables(trainer.ema_model), jstate['ema'],
                       tol, 'ema')


def check_validation(variant, tmp_path):
    """validate() on the CPU against the JAX build_eval_step (fused head
    and Pallas confusion matrix, interpret mode) on the same val batches:
    equal confusion matrices."""
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.step import build_eval_step
    v = variables(variant)
    trainer = SegTrainer(port_config(variant, tmp_path), device='cpu',
                         variables=v)
    miou = trainer.validate()
    jcfg = jax_config(variant, fused_head=True, use_pallas_metrics=True,
                      use_ema=False)
    step = build_eval_step(jcfg, jax_get_model(jcfg), _mesh(), use_ema=False)
    assert step.defer_upsample
    state = jax_state(v)
    want = np.zeros((NC, NC), np.int64)
    for imgs, msks in trainer.val_loader:
        want += np.asarray(step(state, jnp.asarray(imgs.numpy()),
                                jnp.asarray(msks.numpy())), np.int64)
    assert int(want.sum()) == 16 * H * W
    np.testing.assert_array_equal(trainer.last_cm, want)
    assert np.isfinite(miou)


@pytest.mark.parametrize('variant', ['bisenetv1', 'icnet_aux'])
def test_three_train_steps_match_jax(variant, tmp_path):
    """BiSeNetv1 (CE) and ICNet with its two aux heads (OHEM, the aux
    losses on nearest-resized masks), SGD cos_warmup + EMA, 3 float32
    steps of 4 distinct samples: each step's loss within 1e-5 relative;
    params, batch_stats and their EMA within 1e-4."""
    check_steps(variant, 3, tmp_path)


def test_icnet_validation_equals_the_jax_eval_step(tmp_path):
    """ICNet's 1/4-resolution logits through the fused head."""
    check_validation('icnet_aux', tmp_path)


def test_icnet_run_trains_and_validates_on_the_cpu(tmp_path):
    """SegTrainer(cfg, device='cpu').run() of ICNet with its aux heads:
    2 epochs of 3 steps, finite epoch losses, the step count, and every
    val pixel counted in each validation of the EMA weights."""
    trainer = SegTrainer(port_config('icnet_aux', tmp_path), device='cpu',
                         variables=variables('icnet_aux'))
    score = trainer.run()
    assert np.isfinite(score)
    assert len(trainer.epoch_losses) == 2
    assert all(np.isfinite(trainer.epoch_losses))
    assert trainer.state.step == 6
    assert int(trainer.last_cm.sum()) == 16 * H * W
