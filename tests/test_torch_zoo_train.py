"""PyTorch port against the JAX package: training and validation of
FastSCNN, DDRNet-23-slim with its aux head and STDC1 with its detail head
(and with its aux heads) through the port's train step and SegTrainer, on
the CPU.

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
# 12 train samples: 3 steps an epoch, the third at the peak LR; 16 val
# samples at bs 8. The peak LR is 1e-3, not the default 1e-2: from random
# weights the third step at 1e-2 moves DDRNet's and STDC's stems so far
# that float32 rounding alone (the JAX package's own float32 run against
# its float64 run) parts the weights by more than the tolerances below
KW = dict(num_class=NC, dataset='synthetic', crop_h=H, crop_w=W,
          train_bs=BS, val_bs=8, synthetic_len=12, total_epoch=2,
          warmup_epochs=1, lr_policy='cos_warmup', base_lr=1e-3,
          optimizer_type='sgd', loss_type='ce', use_ema=True,
          compute_dtype='float32', random_seed=3, use_aux=False)
VARIANTS = {
    'fastscnn': dict(model='fastscnn'),
    'ddrnet_aux': dict(model='ddrnet', use_aux=True, loss_type='ohem'),
    # weight decay large enough that the decay of detail_conv, which has
    # no gradient, shows far above the tolerances
    'stdc_detail': dict(model='stdc', use_detail_head=True,
                        weight_decay=0.5),
    'stdc_aux': dict(model='stdc', use_aux=True),
}
PORT_ONLY = dict(use_tb=False, use_obs=False, base_workers=0)
DETAIL_CONV = ('params', 'detail_conv', 'conv', 'kernel')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(variant):
    return {**KW, **VARIANTS[variant]}


def _config(variant, save_dir, **kw):
    return SegConfig(**{**_kw(variant), **PORT_ONLY,
                        'save_dir': str(save_dir), **kw})


def _jax_config(variant, **kw):
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    jcfg = JaxSegConfig(**{**_kw(variant), **kw})
    jcfg.resolve(num_devices=1)
    return jcfg


@pytest.fixture(scope='module')
def variables():
    return {v: random_jax_variables(get_model(SegConfig(**_kw(v))), seed=i)
            for i, v in enumerate(VARIANTS)}


def _mesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ('data',))


def _jax_state(variables, opt=None):
    from rtseg_tpu.train.state import TrainState
    params = jax.tree.map(jnp.asarray, variables['params'])
    stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats,
                      opt_state=opt.init(params) if opt else (),
                      ema_params=jax.tree.map(jnp.copy, params),
                      ema_batch_stats=jax.tree.map(jnp.copy, stats))


def _batches(variant, n=3):
    """n train batches of BS distinct synthetic samples (the JAX
    package's own dataset)."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    ds = JaxSynthetic(JaxSegConfig(**_kw(variant)), mode='train')
    return [tuple(np.stack(a) for a in zip(*(ds.get(k * BS + i)
                                             for i in range(BS))))
            for k in range(n)]


def _assert_trees_close(got, want, tol, what):
    """Every leaf within tol, as np.allclose(atol=tol, rtol=tol)."""
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert got.keys() == want.keys(), what
    worst = max((float((np.abs(got[k] - want[k])
                        - tol * np.abs(want[k])).max()), k) for k in got)
    assert worst[0] <= tol, (what, worst)


# ------------------------------------------------------------- the steps

@pytest.fixture(scope='module')
def three_steps(variables, tmp_path_factory):
    """{variant: (JAX losses and metrics, JAX state after 3 steps, port
    losses and metrics, port trainer)} for 3 float32 steps from the same
    variables on the same batches; each JAX step compiled once."""
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.step import build_train_step as jax_train_step
    out = {}
    for variant in ('ddrnet_aux', 'stdc_detail'):
        jcfg = _jax_config(variant)
        jcfg.resolve_schedule(train_num=KW['synthetic_len'])
        opt = get_optimizer(jcfg)
        step = jax_train_step(jcfg, jax_get_model(jcfg), opt, _mesh())
        state = _jax_state(variables[variant], opt)
        batches = _batches(variant)
        jmetrics = []
        for imgs, msks in batches:
            state, m = step(state, jnp.asarray(imgs), jnp.asarray(msks))
            jmetrics.append({k: float(v) for k, v in m.items()})
        jstate = jax.device_get(
            {'variables': {'params': state.params,
                           'batch_stats': state.batch_stats},
             'ema': {'params': state.ema_params,
                     'batch_stats': state.ema_batch_stats}})
        trainer = SegTrainer(
            _config(variant, tmp_path_factory.mktemp(variant)),
            device='cpu', variables=variables[variant])
        tmetrics = []
        for imgs, msks in batches:
            trainer.state, m = trainer.train_step(
                trainer.state, torch.from_numpy(imgs),
                torch.from_numpy(msks))
            tmetrics.append({k: float(v) for k, v in m.items()})
        out[variant] = (jmetrics, jstate, tmetrics, trainer)
    return out


@pytest.mark.parametrize('variant', ['ddrnet_aux', 'stdc_detail'])
def test_three_train_steps_match_jax(three_steps, variant):
    """DDRNet + aux + OHEM and STDC + detail head, SGD cos_warmup + EMA,
    3 float32 steps of 4 distinct samples: each step's loss (and
    loss_detail) within 1e-5 relative; params, batch_stats and their EMA
    within 1e-4."""
    jmetrics, jstate, tmetrics, trainer = three_steps[variant]
    assert trainer.state.step == 3
    for j, t in zip(jmetrics, tmetrics):
        assert set(t) == set(j)
        assert set(t) == ({'loss', 'loss_detail'}
                          if variant == 'stdc_detail' else {'loss'})
        for k in j:
            assert t[k] == pytest.approx(j[k], rel=1e-5), k
    _assert_trees_close(to_jax_variables(trainer.model),
                        jstate['variables'], 1e-4, 'params/batch_stats')
    _assert_trees_close(to_jax_variables(trainer.ema_model), jstate['ema'],
                        1e-4, 'ema')


def test_a_parameter_without_gradient_decays_as_optax_decays_it(
        three_steps, variables):
    """STDC's detail_conv gets no gradient (the detail targets are made on
    detached weights). optax's chain still decays it and moves its
    momentum; torch SGD skips a parameter whose gradient is None, so the
    step gives it a zero gradient. After 3 steps its kernel equals the JAX
    step's within 1e-6 and has moved from its start by far more."""
    _, jstate, _, trainer = three_steps['stdc_detail']
    start = dict(_flatten(variables['stdc_detail']))[DETAIL_CONV]
    want = dict(_flatten(jstate['variables']))[DETAIL_CONV]
    got = dict(_flatten(to_jax_variables(trainer.model)))[DETAIL_CONV]
    assert np.abs(want - start).max() > 100 * 1e-6
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    conv = trainer.model.detail_conv.conv.weight
    assert torch.count_nonzero(conv.grad) == 0
    assert 'momentum_buffer' in trainer.state.optimizer.state[conv]


# -------------------------------------------------------------- validate

@pytest.mark.parametrize('variant', ['fastscnn', 'ddrnet_aux',
                                     'stdc_detail'])
def test_validation_equals_the_jax_eval_step(variables, variant, tmp_path):
    """validate() on the CPU against the JAX build_eval_step (fused head
    and Pallas confusion matrix, interpret mode) on the same val batches:
    equal confusion matrices."""
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.step import build_eval_step
    trainer = SegTrainer(_config(variant, tmp_path), device='cpu',
                         variables=variables[variant])
    miou = trainer.validate()
    jcfg = _jax_config(variant, fused_head=True, use_pallas_metrics=True,
                       use_ema=False)
    step = build_eval_step(jcfg, jax_get_model(jcfg), _mesh(),
                           use_ema=False)
    assert step.defer_upsample
    state = _jax_state(variables[variant])
    want = np.zeros((NC, NC), np.int64)
    for imgs, msks in trainer.val_loader:
        want += np.asarray(step(state, jnp.asarray(imgs.numpy()),
                                jnp.asarray(msks.numpy())), np.int64)
    assert int(want.sum()) == 16 * H * W
    np.testing.assert_array_equal(trainer.last_cm, want)
    assert np.isfinite(miou)


# ------------------------------------------------------------------ run()

@pytest.mark.parametrize('variant', list(VARIANTS))
def test_run_trains_and_validates_on_the_cpu(variables, variant, tmp_path):
    """SegTrainer(cfg, device='cpu').run(): 2 epochs of 3 steps, finite
    epoch losses, the step count, and every val pixel counted in each
    validation of the EMA weights."""
    trainer = SegTrainer(_config(variant, tmp_path), device='cpu',
                         variables=variables[variant])
    score = trainer.run()
    assert np.isfinite(score)
    assert len(trainer.epoch_losses) == 2
    assert all(np.isfinite(trainer.epoch_losses))
    assert trainer.state.step == 6
    assert int(trainer.last_cm.sum()) == 16 * H * W
