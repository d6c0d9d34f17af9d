"""PyTorch port against the JAX package: BiSeNetv2's training forward, the
train step (aux heads, OHEM, SGD under OneCycle, EMA), and
SegTrainer.run() with its checkpoints, on the CPU.

The same seeded Flax-shaped variables (made with numpy by the port) start
both packages, and the same synthetic batches (the JAX package's own
loader) drive the JAX build_train_step on a one-device mesh and the port.
The JAX step is compiled once for the module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train import SegTrainer, build_train_step
from rtseg_tpu_torch.utils.convert import (load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)

NC, H, W = 19, 64, 128
# 4 train samples at bs 4: 1 step an epoch; 16 val samples
KW = dict(model='bisenetv2', use_aux=True, num_class=NC, dataset='synthetic',
          crop_h=H, crop_w=W, train_bs=4, val_bs=8, synthetic_len=4,
          total_epoch=2, warmup_epochs=1, lr_policy='cos_warmup',
          optimizer_type='sgd', loss_type='ohem', use_ema=True,
          compute_dtype='float32', random_seed=3)
PORT_ONLY = dict(use_tb=False, use_obs=False, base_workers=0)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(save_dir, **kw):
    return SegConfig(**{**KW, **PORT_ONLY, 'save_dir': str(save_dir), **kw})


@pytest.fixture(scope='module')
def variables():
    return random_jax_variables(get_model(SegConfig(**KW)), seed=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


def _assert_trees_close(got, want, tol, what):
    """Every leaf within tol, as np.allclose(atol=tol, rtol=tol)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), what
    worst = max((float((np.abs(got[k] - want[k])
                        - tol * np.abs(want[k])).max()), k) for k in got)
    assert worst[0] <= tol, (what, worst)


@pytest.fixture(scope='module')
def jax_train(variables):
    """run(batches) -> (per-step losses, {step: state}) of the JAX
    package's train step from `variables`; the step is compiled once."""
    from jax.sharding import Mesh
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.state import TrainState
    from rtseg_tpu.train.step import build_train_step as jax_train_step

    jcfg = JaxSegConfig(**KW)
    jcfg.resolve(num_devices=1)
    jcfg.resolve_schedule(train_num=KW['synthetic_len'])
    model, opt = jax_get_model(jcfg), get_optimizer(jcfg)
    step = jax_train_step(jcfg, model, opt,
                          Mesh(np.array(jax.devices()[:1]), ('data',)))

    def run(batches):
        params = jax.tree.map(jnp.asarray, variables['params'])
        stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=opt.init(params),
                           ema_params=jax.tree.map(jnp.copy, params),
                           ema_batch_stats=jax.tree.map(jnp.copy, stats))
        losses, states = [], {}
        for imgs, msks in batches:
            state, metrics = step(state, jnp.asarray(imgs), jnp.asarray(msks))
            losses.append(float(metrics['loss']))
            # a copy: the next call donates this state's buffers
            states[len(losses)] = jax.tree.map(
                lambda a: np.array(a, copy=True),
                {'variables': {'params': state.params,
                               'batch_stats': state.batch_stats},
                 'ema': {'params': state.ema_params,
                         'batch_stats': state.ema_batch_stats},
                 'step': state.step})
        return losses, states
    return run


def _jax_batches(epochs):
    """The JAX package's own train loader, epoch by epoch."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.loader import ShardedLoader
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    jcfg = JaxSegConfig(**KW)
    loader = ShardedLoader(JaxSynthetic(jcfg, mode='train'), KW['train_bs'],
                           seed=KW['random_seed'], shuffle=True,
                           drop_last=True)
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out += list(loader)
    return out


# ------------------------------------------------------------ the model

def test_training_forward_and_batch_stats_match_flax(variables):
    """Logits, the 4 aux logits (1/4 .. 1/32) and the updated batch_stats
    of one training forward within 1e-4."""
    from rtseg_tpu.models.bisenetv2 import BiSeNetv2 as FlaxBiSeNetv2
    x = np.random.RandomState(42).uniform(-1.5, 1.5,
                                          (2, H, W, 3)).astype(np.float32)
    fmodel = FlaxBiSeNetv2(num_class=NC, use_aux=True)
    (logits, aux), mut = jax.jit(
        lambda v, x: fmodel.apply(v, x, True, mutable=['batch_stats']))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    model = get_model(SegConfig(**KW))
    load_jax_variables(model, variables)
    with torch.no_grad():
        got, got_aux = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                               atol=1e-4, rtol=1e-4)
    assert len(got_aux) == len(aux) == 4
    for i, (g, a) in enumerate(zip(got_aux, aux)):
        assert tuple(g.shape) == (2, H // 2 ** (i + 2), W // 2 ** (i + 2),
                                  NC)
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=1e-4)
    _assert_trees_close(to_jax_variables(model)['batch_stats'],
                        jax.device_get(mut['batch_stats']), 1e-4,
                        'batch_stats')
    # without aux heads the training forward returns the logits alone
    plain = get_model(SegConfig(**{**KW, 'use_aux': False}))
    assert plain.train()(torch.from_numpy(x[:1])).shape == (1, H, W, NC)


# -------------------------------------------------------------- the step

def test_three_train_steps_match_jax(variables, jax_train, tmp_path):
    """3 float32 steps of BiSeNetv2 + aux + OHEM + EMA + SGD cos_warmup
    on batches of 4 distinct samples: per-step loss within 1e-4 relative;
    params, batch_stats, EMA params and EMA batch_stats within 1e-4.

    The context block's BatchNorm normalizes the pooled features, B values
    a channel, with the variance E[x^2] - E[x]^2 (the JAX formula, which
    the port keeps). Where the images of a batch pool alike that variance
    cancels, and the float32 rounding of the convs before it (XLA against
    oneDNN, about 1e-6) moves the semantic branch's gradient by percents
    and grows in each large update. At 4 samples of 64x128 the packages
    stay well inside the tolerance."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    ds = JaxSynthetic(JaxSegConfig(**KW), mode='train')
    bs = KW['train_bs']
    batches = [tuple(np.stack(a) for a in zip(*(ds.get(k * bs + i)
                                                 for i in range(bs))))
               for k in range(3)]
    losses, states = jax_train(batches)
    trainer = SegTrainer(_config(tmp_path), device='cpu',
                         variables=variables)
    assert trainer.config.total_itrs == 2      # step 3 runs past the end
    for k, (imgs, msks) in enumerate(batches):
        trainer.state, metrics = trainer.train_step(
            trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
        assert metrics['loss'].dtype == torch.float32
        assert float(metrics['loss']) == pytest.approx(losses[k], rel=1e-4)
    assert trainer.state.step == int(states[3]['step']) == 3
    _assert_trees_close(to_jax_variables(trainer.model),
                        states[3]['variables'], 1e-4, 'params/batch_stats')
    _assert_trees_close(to_jax_variables(trainer.ema_model),
                        states[3]['ema'], 1e-4, 'ema')
    for p in trainer.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


def test_bf16_step_leaves_float32_grads_on_float32_params(variables,
                                                          tmp_path):
    cfg = _config(tmp_path, compute_dtype='bfloat16', crop_h=32, crop_w=64)
    trainer = SegTrainer(cfg, device='cpu', variables=variables)
    imgs, msks = next(iter(trainer.train_loader))
    _, metrics = trainer.train_step(trainer.state, imgs, msks)
    assert np.isfinite(float(metrics['loss']))
    for p in trainer.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()


def test_without_ema_the_ema_model_mirrors_the_weights(variables, tmp_path):
    trainer = SegTrainer(_config(tmp_path, use_ema=False), device='cpu',
                         variables=variables)
    for imgs, msks in trainer.train_loader:
        trainer.train_step(trainer.state, imgs, msks)
    ema, model = trainer.ema_model.state_dict(), trainer.model.state_dict()
    for k, v in model.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(ema[k], v), k


def test_validation_runs_the_ema_weights(variables, tmp_path):
    """After EMA training steps, validate() is the validation of the EMA
    weights, not of the trained weights."""
    trainer = SegTrainer(_config(tmp_path / 'a'), device='cpu',
                         variables=variables)
    for imgs, msks in trainer.train_loader:
        trainer.train_step(trainer.state, imgs, msks)
    trainer.train_step(trainer.state, imgs, msks)
    trainer.validate()
    ema_vars = to_jax_variables(trainer.ema_model)
    model_vars = to_jax_variables(trainer.model)
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in
               zip(_leaves(ema_vars), _leaves(model_vars)))
    twin = SegTrainer(_config(tmp_path / 'b'), device='cpu',
                      variables=ema_vars)
    twin.validate()
    np.testing.assert_array_equal(trainer.last_cm, twin.last_cm)
    assert not trainer.ema_model.training


def test_train_step_refuses_what_it_does_not_implement(tmp_path):
    cfg = _config(tmp_path, kd_training=True)
    cfg.resolve(num_devices=1)
    cfg.resolve_schedule(4)
    # KD is ported: without its teacher the step is refused
    # (tests/test_torch_kd.py holds the KD step to the JAX package's)
    with pytest.raises(ValueError, match='teacher'):
        build_train_step(cfg)
    # norm_coeffs is ported (tests/test_torch_augment.py): a step built
    # without it refuses flip flags
    plain = _config(tmp_path)
    plain.resolve(num_devices=1)
    plain.resolve_schedule(4)
    with pytest.raises(ValueError, match='norm_coeffs'):
        build_train_step(plain)(None, torch.zeros(1), torch.zeros(1),
                                torch.zeros(1, 2, dtype=torch.uint8))
    # the detail head is built (STDC's train step is held to the JAX
    # package in tests/test_torch_zoo_train.py)
    cfg = _config(tmp_path, model='stdc', use_aux=False,
                  use_detail_head=True)
    cfg.resolve(num_devices=1)
    cfg.resolve_schedule(4)
    build_train_step(cfg)
    for kw in (dict(model='fastscnn', use_aux=True),
               dict(model='stdc', use_aux=True, use_detail_head=True)):
        with pytest.raises(ValueError, match='support'):
            get_model(SegConfig(**{**KW, **kw}))
    # the smp hub is ported: it refuses a decoder it does not know, as the
    # JAX package does (tests/test_torch_smp_models.py)
    with pytest.raises(ValueError, match='Unsupported decoder type'):
        get_model(SegConfig(**{**KW, 'model': 'smp', 'use_aux': False}))
    cfg = _config(tmp_path, aux_coef=(1.0, 1.0))
    trainer = SegTrainer(cfg, device='cpu')
    imgs, msks = next(iter(trainer.train_loader))
    with pytest.raises(ValueError, match='coefficient length'):
        trainer.train_step(trainer.state, imgs, msks)


@pytest.mark.parametrize('flag,value', [('compile_cache', True)])
def test_run_refuses_the_planes_not_ported(tmp_path, flag, value):
    """compile_cache, refused until the warm starts were ported, now
    builds the trainer with its cache (tests/test_torch_warm_trainer.py
    runs it); the process's compile cache is turned off again."""
    from rtseg_tpu_torch.warm import ExeCache, compile_cache
    try:
        trainer = SegTrainer(_config(tmp_path, **{flag: value}),
                             device='cpu')
        assert isinstance(trainer._exe_cache, ExeCache)
        assert compile_cache.active_cache() is trainer._exe_cache
        assert trainer.eval_step.exe_cache is trainer._exe_cache
    finally:
        compile_cache.disable_compile_cache()


# ------------------------------------------------------------------ run()

def test_run_matches_jax_and_resumes_exactly(variables, jax_train,
                                            tmp_path):
    """run() for 2 epochs of one step: the epoch losses against the JAX
    step's over the JAX loader's batches (within 1e-4 relative), best/last
    written, a second trainer resumes the full state exactly, and
    val_best() reads best."""
    losses, states = jax_train(_jax_batches(2))
    cfg = _config(tmp_path)
    trainer = SegTrainer(cfg, device='cpu', variables=variables)
    score = trainer.run()
    assert np.isfinite(score)
    np.testing.assert_allclose(trainer.epoch_losses, losses, rtol=1e-4)
    assert trainer.state.step == 2

    from rtseg_tpu_torch.train.checkpoint import load_meta
    for name, kind in (('last.ckpt', 'train'), ('best.ckpt', 'best')):
        path = tmp_path / name
        assert (path / 'state.pt').exists(), name
        meta = load_meta(str(path))
        # a train checkpoint names the optimizer whose state it holds
        extra = {'optimizer'} if kind == 'train' else set()
        assert meta['kind'] == kind and set(meta) == {'kind', 'cur_epoch',
                                                      'best_score'} | extra
    assert load_meta(str(tmp_path / 'last.ckpt'))['cur_epoch'] == 2

    resumed = SegTrainer(_config(tmp_path), device='cpu')
    assert resumed.cur_epoch == 2 and resumed.state.step == 2
    assert resumed.best_score == trainer.best_score
    for k, v in trainer.model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(resumed.model.state_dict()[k], v), k
    bufs = {n: trainer.state.optimizer.state[p]['momentum_buffer']
            for n, p in trainer.model.named_parameters()}
    for n, p in resumed.model.named_parameters():
        assert torch.equal(resumed.state.optimizer.state[p]
                           ['momentum_buffer'], bufs[n]), n
    # run() ended in val_best(), which put best's EMA into trainer's EMA
    # model; last.ckpt holds the EMA of the last step
    last = torch.load(tmp_path / 'last.ckpt' / 'state.pt',
                      weights_only=True)
    _assert_trees_close(to_jax_variables(resumed.ema_model),
                        last['ema_variables'], 0.0, 'ema')
    # the resumed trainer has nothing left to train and re-validates best
    assert resumed.run() == pytest.approx(score, abs=1e-12)

    # val_best() reloads best.ckpt into the EMA model before validating
    load_jax_variables(trainer.ema_model,
                       random_jax_variables(trainer.ema_model, seed=9))
    assert trainer.val_best() == pytest.approx(score, abs=1e-12)
    assert os.path.isdir(tmp_path / 'best.ckpt')
