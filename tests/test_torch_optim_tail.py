"""PyTorch port against the JAX package: Adam and AdamW with OneCycle's
cycled beta1, their train steps and checkpoints, the async checkpoint
writer, and the switches the port refuses or accepts.

* Five Adam and AdamW updates on fixed gradients against the optax chain
  of the JAX package's get_optimizer, under each LR policy: within 1e-6
  relative (and 1e-7 absolute, as SGD's in tests/test_torch_train_ops.py).
* Three float32 train steps of FPN on MiT-b0 under AdamW (and, with
  remat, under Adam: tests/test_torch_remat.py) against the JAX
  build_train_step, from the tests' seeded draw with the
  same drop-path and dropout masks in both packages, at the start of a
  long warmup (LR near its floor of 1e-3 / 25): each step's loss within
  1e-5 relative; params and their EMA within 1e-4. Adam moves an element
  by about the LR whichever sign the rounding gives its gradient, so
  where a gradient is rounding noise (a conv bias before a train-mode
  BatchNorm, an element near a sign change) two runs part by up to twice
  the LRs summed (3.1e-3 at the SGD tests' schedule, peak LR by the third
  step; 2.4e-4 here), and the two packages' gradients round differently.
  MiT FPN has no BatchNorm: two CPU runs from weights 1e-7 apart part by
  1.9e-5-2.2e-5 after 3 steps here (zoo_check_spread.py
  adamw-smp-mit_b2-fpn:4). BiSeNetv2's part by 1.5e-4-1.7e-4
  (adam-bisenetv2:4), beyond the tolerance: it is held under Adam on the
  card against the CPU path (chip_smoke.py, limit 1e-3).
* An Adam checkpoint resumes exactly (weights, moments, counts, EMA; one
  more step equal); a resume under another optimizer raises naming both;
  AsyncCkptWriter's ordering, error and double-close contract.
* F3: each switch of the JAX trainer and loader that the port does not
  implement raises, naming its ROADMAP.md item; recompile_guard and
  device_prefetch are accepted and change no result.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.train import optim as joptim
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import get_loader
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.train import optim as toptim
from rtseg_tpu_torch.train.checkpoint import (AsyncCkptWriter, load_meta,
                                              restore_train_ckpt,
                                              save_train_ckpt)
from rtseg_tpu_torch.utils.convert import to_jax_variables
from test_torch_resnet_train import PORT_ONLY, assert_trees_close
from test_torch_smp_train_steps import check_smp_steps


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- optimizer

POLICIES = [dict(lr_policy='cos_warmup', warmup_epochs=1, total_epoch=2),
            dict(lr_policy='linear', total_epoch=2),
            dict(lr_policy='step', total_epoch=2, step_size=2,
                 step_gamma=0.5)]


@pytest.mark.parametrize('kind', ['adam', 'adamw'])
@pytest.mark.parametrize('kw', POLICIES, ids=lambda kw: kw['lr_policy'])
def test_adam_matches_the_optax_chain(kind, kw):
    """5 updates of a small tree on fixed gradients against the optax
    chain of get_optimizer: within 1e-6 relative, 1e-7 absolute. beta1 is
    cycled under the OneCycle policies and 0.9 under 'step' (never
    config.momentum)."""
    cfgs = []
    for cls in (JaxSegConfig, SegConfig):
        cfg = cls(optimizer_type=kind, momentum=0.5, weight_decay=0.3, **kw)
        cfg.resolve(num_devices=1)
        cfg.resolve_schedule(train_num=5 * 16)
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    rng = np.random.RandomState(3)
    tree = {'a': rng.randn(4, 3).astype(np.float32),
            'b': rng.randn(7).astype(np.float32)}
    # gradients of different scales, one element always 0
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-3, 2, v.shape)
                  ).astype(np.float32) for k, v in tree.items()}
             for _ in range(5)]
    for g in grads:
        g['b'][0] = 0.0
    jopt = joptim.get_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in tree.items()}
    opt = toptim.get_optimizer(cfg, list(params.values()))
    assert type(opt) is (torch.optim.Adam if kind == 'adam'
                         else torch.optim.AdamW)
    group = opt.param_groups[0]
    assert (group['eps'], group['betas'][1]) == (1e-8, 0.999)
    assert group['weight_decay'] == (0.0 if kind == 'adam' else 1e-2)
    assert group['foreach'] and not group['fused']
    assert 'momentum' not in group
    lr, mom = toptim.get_lr_schedule(cfg), toptim.optimizer_momentum(cfg)
    assert callable(mom) == (kw['lr_policy'] != 'step')
    for k, g in enumerate(grads):
        beta1 = mom(k) if callable(mom) else mom
        assert beta1 == (0.9 if not callable(mom) else beta1)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        toptim.set_hparams(opt, lr(k), beta1)
        assert group['betas'] == (beta1, 0.999) and 'momentum' not in group
        for name, p in params.items():
            p.grad = torch.from_numpy(g[name])
        opt.step()
        for name, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[name]),
                                       rtol=1e-6, atol=1e-7)


def test_config_momentum_is_sgd_only():
    """Under 'step', SGD takes config.momentum and Adam torch's 0.9; the
    OneCycle policies cycle both the same way."""
    for kind, want in (('sgd', 0.5), ('adam', 0.9), ('adamw', 0.9)):
        cfg = SegConfig(optimizer_type=kind, momentum=0.5, lr_policy='step',
                        total_epoch=1)
        cfg.resolve(num_devices=1)
        cfg.resolve_schedule(16)
        assert toptim.optimizer_momentum(cfg) == want
        jcfg = JaxSegConfig(optimizer_type=kind, momentum=0.5,
                            lr_policy='step', total_epoch=1)
        assert joptim.get_momentum(
            jcfg, 0.9 if kind != 'sgd' else None) == want
    with pytest.raises(NotImplementedError, match='rmsprop'):
        toptim.get_optimizer(SegConfig(optimizer_type='rmsprop'),
                             [torch.nn.Parameter(torch.ones(1))])


# ------------------------------------------------------------- train steps

# the start of a long warmup: the LR near its floor of 1e-3 / 25 (see the
# module docstring)
WARMUP = dict(total_epoch=100, warmup_epochs=50)


def test_adamw_steps_match_jax(tmp_path):
    """FPN on MiT-b0 under AdamW, three steps with the same drop-path and
    dropout masks in both packages, beta1 cycled by cos_warmup."""
    trainer = check_smp_steps('mit_b0', 'fpn', 3, tmp_path,
                              config=dict(WARMUP, optimizer_type='adamw'))
    group = trainer.state.optimizer.param_groups[0]
    assert group['betas'][0] != 0.9 and 'momentum' not in group


# ------------------------------------------------------------- checkpoints

def _tiny(tmp_path, **kw):
    return SegConfig(**{**PORT_ONLY, 'model': 'fastscnn', 'num_class': 6,
                        'use_aux': False, 'dataset': 'synthetic',
                        'crop_h': 32, 'crop_w': 64, 'train_bs': 2,
                        'val_bs': 2, 'synthetic_len': 4, 'total_epoch': 2,
                        'compute_dtype': 'float32', 'random_seed': 4,
                        'save_dir': str(tmp_path), **kw})


@pytest.mark.parametrize('kind', ['adam', 'adamw'])
def test_adam_checkpoint_resumes_exactly(tmp_path, kind):
    """run() for 1 of 2 epochs writes last.ckpt with the moments and the
    count under the Flax paths and the optimizer in the meta; a fresh
    trainer resumes weights, moments, counts, step and EMA bit for bit,
    and one more step from each is equal."""
    first = SegTrainer(_tiny(tmp_path, optimizer_type=kind, total_epoch=1),
                       device='cpu')
    first.run()
    meta = load_meta(str(tmp_path / 'last.ckpt'))
    assert meta['optimizer'] == kind and meta['kind'] == 'train'
    payload = torch.load(tmp_path / 'last.ckpt' / 'state.pt',
                         weights_only=True)
    assert payload['adam_step'] == payload['step'] == 2
    assert 'momentum' not in payload
    params = to_jax_variables(first.model)['params']
    for key in ('exp_avg', 'exp_avg_sq'):
        assert set(payload[key]) == {'params'}
        assert jax.tree.map(np.shape, payload[key]['params']) == \
            jax.tree.map(np.shape, params)
    resumed = SegTrainer(_tiny(tmp_path, optimizer_type=kind), device='cpu')
    assert resumed.state.step == 2 and resumed.cur_epoch == 1
    a, b = first.state, resumed.state
    assert_trees_close(to_jax_variables(b.model), to_jax_variables(a.model),
                       0.0, 'weights')
    assert_trees_close(to_jax_variables(b.ema_model),
                       to_jax_variables(a.ema_model), 0.0, 'ema')
    names = dict(a.model.named_parameters())
    for n, p in b.model.named_parameters():
        sa, sb = a.optimizer.state[names[n]], b.optimizer.state[p]
        assert sa.keys() == sb.keys() == {'step', 'exp_avg', 'exp_avg_sq'}
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and \
                sa[k].device == sb[k].device, (n, k)
            assert torch.equal(sa[k], sb[k]), (n, k)
    imgs, msks = next(iter(first.train_loader))
    for t in (first, resumed):
        t.train_step(t.state, imgs, msks)
    assert_trees_close(to_jax_variables(b.model), to_jax_variables(a.model),
                       0.0, 'one more step')


def test_resume_under_another_optimizer_raises(tmp_path):
    first = SegTrainer(_tiny(tmp_path, optimizer_type='adamw',
                             total_epoch=1), device='cpu')
    imgs, msks = next(iter(first.train_loader))
    first.train_step(first.state, imgs, msks)
    save_train_ckpt(str(tmp_path / 'last.ckpt'), first.state, 1, 0.0)
    for kind in ('sgd', 'adam'):
        with pytest.raises(ValueError, match=f"'adamw'.*'{kind}'"):
            SegTrainer(_tiny(tmp_path, optimizer_type=kind), device='cpu')
    sgd = SegTrainer(_tiny(tmp_path / 'b', optimizer_type='sgd'),
                     device='cpu')
    sgd.train_step(sgd.state, imgs, msks)
    save_train_ckpt(str(tmp_path / 'sgd'), sgd.state, 1, 0.0)
    with pytest.raises(ValueError, match="'sgd'.*'adamw'"):
        restore_train_ckpt(str(tmp_path / 'sgd'), first.state)


def test_async_writer_orders_raises_and_closes_twice():
    """One deep: submit joins the write in flight, so writes land in
    order; a failed write raises on the next submit or join, once; join
    and close are idempotent and a join from the writer thread itself does
    not wait on itself."""
    writer, order = AsyncCkptWriter(), []
    gate = threading.Event()

    def slow(tag):
        def write():
            gate.wait(10)
            time.sleep(0.05)
            order.append(tag)
        return write

    writer.submit(slow(1))
    gate.set()
    writer.submit(slow(2))          # joins write 1 first
    assert order == [1]
    writer.join()
    assert order == [1, 2]

    def fail():
        raise OSError('disk full')
    writer.submit(fail)
    with pytest.raises(RuntimeError, match='checkpoint write failed') as e:
        writer.submit(lambda: order.append(3))
    assert isinstance(e.value.__cause__, OSError)
    writer.join()                   # the error was raised once; nothing new
    assert order == [1, 2]
    writer.submit(fail)
    with pytest.raises(RuntimeError):
        writer.join()
    writer.close()
    writer.close()

    inner = []
    writer.submit(lambda: (writer.join(), inner.append('no self-join')))
    writer.close()
    assert inner == ['no self-join']
    assert writer._thread is None


def test_run_writes_through_the_writer_and_joins_it(tmp_path, monkeypatch):
    """run() hands every checkpoint write to the writer thread and leaves
    none in flight; val_best() and a resume join it first."""
    from rtseg_tpu_torch.train import trainer as trainer_mod
    writers = []
    real = trainer_mod.write_train_ckpt

    def on_thread(*args):
        writers.append(threading.current_thread().name)
        real(*args)
    monkeypatch.setattr(trainer_mod, 'write_train_ckpt', on_thread)
    t = SegTrainer(_tiny(tmp_path, optimizer_type='adam'), device='cpu')
    t.run()
    assert writers == ['ckpt-writer'] * 2
    assert t._ckpt_writer._thread is None
    assert load_meta(str(tmp_path / 'last.ckpt'))['cur_epoch'] == 2


# --------------------------------------------------------------------- F3

@pytest.mark.parametrize('flag,value,item', [
    ('is_testing', True, 'Serving engine and predict'),
    ('spatial_partition', 2, 'Data parallel'),
    ('segpipe_cache', True, 'Trainer, checkpoint and data'),
    ('aug_workers', 2, 'Trainer, checkpoint and data')])
def test_switches_not_ported_raise(tmp_path, flag, value, item):
    cfg = _tiny(tmp_path, **{flag: value})
    with pytest.raises(NotImplementedError,
                       match=f'{flag}=.*ROADMAP.md Queue 1, "{item}"'):
        SegTrainer(cfg, device='cpu')
    if flag in ('segpipe_cache', 'aug_workers'):
        with pytest.raises(NotImplementedError, match=flag):
            get_loader(_tiny(tmp_path, **{flag: value}))


def test_device_norm_resolves_as_jax():
    """synthetic has no uint8 hand-off: None resolves to False, True
    raises the JAX package's ValueError."""
    from rtseg_tpu.data import get_loader as jax_get_loader
    messages = []
    for get, cls in ((get_loader, SegConfig), (jax_get_loader, JaxSegConfig)):
        cfg = cls(**dict(_tiny('unused').to_dict(), device_norm=None))
        cfg.resolve(num_devices=1)
        get(cfg)
        assert cfg.device_norm_resolved is False
        cfg = cls(**dict(_tiny('unused').to_dict(), device_norm=True))
        cfg.resolve(num_devices=1)
        with pytest.raises(ValueError, match='device_norm=True') as e:
            get(cfg)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_accepted_switches_change_no_result(tmp_path):
    """recompile_guard and device_prefetch are accepted: a step with them
    set equals the step without."""
    weights = []
    for i, kw in enumerate((dict(), dict(recompile_guard=True,
                                         device_prefetch=0))):
        t = SegTrainer(_tiny(tmp_path / str(i), **kw), device='cpu')
        imgs, msks = next(iter(t.train_loader))
        t.train_step(t.state, imgs, msks)
        weights.append(to_jax_variables(t.model))
    assert_trees_close(weights[1], weights[0], 0.0, 'accepted switches')
