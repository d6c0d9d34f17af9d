"""PyTorch port against the JAX package: the pieces of the training path
below the model (nearest resize, the losses, the LR and momentum
schedules, SGD, train-mode BatchNorm, the train loader).

Inputs are made with numpy from fixed seeds and go through both packages;
the port runs on CPU tensors. Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.losses import losses as jlosses
from rtseg_tpu.ops import resize as jresize
from rtseg_tpu.train import optim as joptim

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.losses import cross_entropy, get_loss_fn, \
    ohem_cross_entropy
from rtseg_tpu_torch.losses import losses as tlosses
from rtseg_tpu_torch.nn.modules import BatchNorm, batch_norm_train
from rtseg_tpu_torch.ops.resize import resize_nearest
from rtseg_tpu_torch.train import optim as toptim

NC = 19


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _case(shape, seed=0, ignore_frac=0.1, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (scale * rng.randn(*shape, NC)).astype(np.float32)
    labels = rng.randint(0, NC, shape).astype(np.int32)
    labels[rng.rand(*shape) < ignore_frac] = 255
    return logits, labels


def _torch_value_and_grad(fn, logits, labels, dtype=torch.float32):
    x = _t(logits).to(dtype).requires_grad_(True)
    loss = fn(x, _t(labels))
    loss.backward()
    return float(loss.detach()), x.grad.float().numpy()


def _jax_value_and_grad(fn, logits, labels, dtype=jnp.float32):
    v, g = jax.jit(jax.value_and_grad(fn))(jnp.asarray(logits, dtype),
                                           jnp.asarray(labels))
    return float(v), np.asarray(g, np.float32)


def _close(got, want, what, grad_tol=1e-6):
    """Value within 1e-6 relative; gradient within grad_tol of the largest
    gradient entry, entry by entry (1e-6; a bf16 gradient is itself bf16,
    so there one bf16 rounding, 2^-8)."""
    (v, g), (vj, gj) = got, want
    assert abs(v - vj) <= 1e-6 * abs(vj), (what, v, vj)
    err = np.abs(g - gj).max()
    assert err <= grad_tol * np.abs(gj).max(), (what, err, np.abs(gj).max())


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize('size', [(16, 32), (5, 7), (33, 65), (8, 16)])
def test_resize_nearest_matches_jax(size):
    x = np.random.RandomState(1).randint(0, 255, (2, 16, 32, 1)
                                         ).astype(np.int32)
    want = np.asarray(jresize.resize_nearest(
        jnp.asarray(x, jnp.float32), size)).astype(np.int32)
    got = resize_nearest(_t(x), size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_operator_made_in_inference_mode_trains():
    """A validation (inference mode) that first asks for an interpolation
    matrix must not leave an inference tensor in the cache for the next
    training step's backward."""
    from rtseg_tpu_torch.ops.resize import interp_operator, \
        resize_bilinear_nchw
    interp_operator.cache_clear()
    x = torch.randn(1, 2, 5, 7)
    with torch.inference_mode():
        resize_bilinear_nchw(x, (9, 11))
    xg = x.clone().requires_grad_(True)
    resize_bilinear_nchw(xg, (9, 11)).sum().backward()
    assert xg.grad.shape == x.shape


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('weighted', [False, True])
def test_cross_entropy_matches_jax(reduction, weighted):
    logits, labels = _case((2, 12, 20))
    labels[0, 0, :3] = (NC, 200, -1)       # outside [0, C), not ignored
    cw = (np.linspace(0.5, 2.0, NC).astype(np.float32) if weighted
          else None)

    def tfn(x, y):
        out = cross_entropy(x, y, 255, cw, reduction)
        return out.sum() if reduction == 'none' else out

    def jfn(x, y):
        out = jlosses.cross_entropy(
            x, y, 255, None if cw is None else jnp.asarray(cw), reduction)
        return out.sum() if reduction == 'none' else out

    _close(_torch_value_and_grad(tfn, logits, labels),
           _jax_value_and_grad(jfn, logits, labels), reduction)
    if reduction == 'none':
        got = cross_entropy(_t(logits), _t(labels), 255, cw, 'none')
        want = jlosses.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels), 255,
                                     None if cw is None else
                                     jnp.asarray(cw), 'none')
        assert got.dtype == torch.float32 and got.shape == labels.shape
        # per pixel: within a float32 rounding of logits of this size
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_cross_entropy_all_ignored_divides_by_the_floor():
    logits, labels = _case((1, 4, 4))
    labels[:] = 255
    got = cross_entropy(_t(logits), _t(labels))
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize('shape,dtype,ignore_frac', [
    ((2, 40, 64), 'float32', 0.1),      # sort branch
    ((2, 40, 64), 'bfloat16', 0.1),     # sort branch, bf16 logits
    ((1, 32, 64), 'float32', 0.9),      # sort, few valid: n_min binds
    ((1, 65, 4033), 'float32', 0.1),    # 2^18 + 1 pixels: bisection
])
def test_ohem_matches_jax_in_both_branches(shape, dtype, ignore_frac):
    n = int(np.prod(shape))
    assert (n > tlosses._OHEM_SORT_LIMIT) == (n > jlosses._OHEM_SORT_LIMIT)
    logits, labels = _case(shape, seed=2, ignore_frac=ignore_frac)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    _close(_torch_value_and_grad(ohem_cross_entropy, logits, labels, tdt),
           _jax_value_and_grad(jlosses.ohem_cross_entropy, logits, labels,
                               jdt), shape,
           grad_tol=2.0 ** -8 if dtype == 'bfloat16' else 1e-6)


def test_ohem_sort_branch_ranks_ties_stably():
    """Equal losses (here every pixel's) are ranked by index, as
    jnp.argsort does: the kept set is the same pixels."""
    logits = np.zeros((1, 8, 8, NC), np.float32)
    labels = np.zeros((1, 8, 8), np.int32)
    labels[0, :, ::2] = 255
    v, g = _torch_value_and_grad(ohem_cross_entropy, logits, labels)
    vj, gj = _jax_value_and_grad(jlosses.ohem_cross_entropy, logits, labels)
    assert v == pytest.approx(vj, rel=1e-6)
    np.testing.assert_array_equal(np.abs(g).sum(-1) > 0,
                                  np.abs(gj).sum(-1) > 0)


def test_get_loss_fn_dispatches_like_jax():
    from rtseg_tpu.losses import get_loss_fn as j_get_loss_fn
    logits, labels = _case((1, 16, 16))
    for kw in (dict(loss_type='ce'), dict(loss_type='ohem', ohem_thrs=0.5),
               dict(loss_type='ce', class_weights=[1.5] * NC,
                    reduction='sum')):
        got = get_loss_fn(SegConfig(**kw))(_t(logits), _t(labels))
        want = j_get_loss_fn(JaxSegConfig(**kw))(jnp.asarray(logits),
                                                 jnp.asarray(labels))
        assert float(got) == pytest.approx(float(want), rel=1e-6), kw
    with pytest.raises(NotImplementedError):
        get_loss_fn(SegConfig(loss_type='dice'))


# --------------------------------------------------------------- schedules

def _configs(**kw):
    out = []
    for cls in (JaxSegConfig, SegConfig):
        cfg = cls(base_lr=0.02, step_size=3, step_gamma=0.5, **kw)
        cfg.resolve(num_devices=1)
        cfg.resolve_schedule(train_num=5 * 16)
        out.append(cfg)
    return out


@pytest.mark.parametrize('kw', [
    dict(lr_policy='cos_warmup', warmup_epochs=1, total_epoch=4),
    dict(lr_policy='cos_warmup', warmup_epochs=0, total_epoch=3),
    dict(lr_policy='cos_warmup', warmup_epochs=6, total_epoch=4),  # pct>1
    dict(lr_policy='linear', total_epoch=4),
    dict(lr_policy='step', total_epoch=4),
])
def test_lr_and_momentum_match_jax_at_every_step(kw):
    """LR and momentum at every step 0..total_itrs+2 within 1e-6
    relative."""
    jcfg, cfg = _configs(**kw)
    lr_j, lr_t = joptim.get_lr_schedule(jcfg), toptim.get_lr_schedule(cfg)
    mom_j, mom_t = joptim.get_momentum(jcfg), toptim.get_momentum(cfg)
    assert callable(mom_j) == callable(mom_t)
    for k in range(cfg.total_itrs + 3):
        want = float(lr_j(k))
        assert lr_t(k) == pytest.approx(want, rel=1e-6), (k, want)
        if callable(mom_j):
            assert mom_t(k) == pytest.approx(float(mom_j(k)), rel=1e-6), k
        else:
            assert mom_t == mom_j == cfg.momentum


def test_onecycle_is_not_torch_onecyclelr_past_the_end():
    """The JAX schedule clamps past total_itrs; torch OneCycleLR raises."""
    _, cfg = _configs(lr_policy='cos_warmup', warmup_epochs=1,
                      total_epoch=2)
    lr = toptim.get_lr_schedule(cfg)
    assert lr(cfg.total_itrs + 5) == lr(cfg.total_itrs - 1)


def test_sgd_matches_the_optax_chain():
    """5 SGD updates (cycled momentum, weight decay, cos_warmup LR) of a
    small tree against the optax chain of get_optimizer: within 1e-6
    relative."""
    jcfg, cfg = _configs(lr_policy='cos_warmup', warmup_epochs=1,
                         total_epoch=2, weight_decay=0.01)
    rng = np.random.RandomState(3)
    tree = {'a': rng.randn(4, 3).astype(np.float32),
            'b': rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(5)]
    jopt = joptim.get_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = {k: torch.nn.Parameter(_t(v.copy())) for k, v in tree.items()}
    opt = toptim.get_optimizer(cfg, list(params.values()))
    lr, mom = toptim.get_lr_schedule(cfg), toptim.get_momentum(cfg)
    for k, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        toptim.set_hparams(opt, lr(k), mom(k))
        for name, p in params.items():
            p.grad = _t(g[name])
        opt.step()
        for name, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[name]),
                                       rtol=1e-6, atol=1e-7)


def test_adam_waits_for_its_roadmap_item():
    """Adam and AdamW, once refused, are ported: get_optimizer builds
    torch's (LR 1e-3, beta1 of OneCycle's first step, beta2 0.999, eps
    1e-8, no decay for Adam, 1e-2 for AdamW), and set_hparams writes beta1
    where SGD's momentum goes (tests/test_torch_optim_tail.py holds them
    to optax)."""
    for name, cls, decay in (('adam', torch.optim.Adam, 0.0),
                             ('adamw', torch.optim.AdamW, 1e-2)):
        cfg = SegConfig(optimizer_type=name, total_epoch=1)
        cfg.resolve(num_devices=1)
        cfg.resolve_schedule(16)
        opt = toptim.get_optimizer(cfg, [torch.nn.Parameter(torch.ones(1))])
        group = opt.param_groups[0]
        assert type(opt) is cls and group['weight_decay'] == decay
        assert group['lr'] == pytest.approx(1e-3 / 25, rel=1e-5)
        assert group['betas'] == (pytest.approx(0.95), 0.999)
        toptim.set_hparams(opt, 1e-3, 0.85)
        assert group['betas'] == (0.85, 0.999) and 'momentum' not in group


# -------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_train_batchnorm_matches_flax(dtype):
    """4 values a channel: output and updated running statistics within
    1e-5 (float32); bf16 output within one bf16 rounding."""
    from rtseg_tpu.nn.modules import BatchNorm as FlaxBN
    rng = np.random.RandomState(4)
    x = (2.0 + 3.0 * rng.randn(2, 2, 1, 6)).astype(np.float32)   # NHWC
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, 6).astype(np.float32)
    mean = rng.uniform(-0.5, 0.5, 6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    variables = {'params': {'bn': {'scale': scale, 'bias': bias}},
                 'batch_stats': {'bn': {'mean': mean, 'var': var}}}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y, mut = FlaxBN().apply(jax.tree.map(jnp.asarray, variables),
                            jnp.asarray(x, jdt), True,
                            mutable=['batch_stats'])
    bn = BatchNorm(6)
    bn.bn.load_state_dict({'weight': _t(scale), 'bias': _t(bias),
                           'running_mean': _t(mean), 'running_var': _t(var),
                           'num_batches_tracked': torch.tensor(0)})
    with torch.no_grad():
        got = bn.train()(_t(x).to(tdt).permute(0, 3, 1, 2))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == 'float32' else 1e-2
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y, np.float32), atol=tol, rtol=tol)
    stats = mut['batch_stats']['bn']
    np.testing.assert_allclose(bn.bn.running_mean.numpy(),
                               np.asarray(stats['mean']), atol=1e-5)
    np.testing.assert_allclose(bn.bn.running_var.numpy(),
                               np.asarray(stats['var']), atol=1e-5)
    # the fault the function repairs: nn.BatchNorm2d's unbiased update
    ref = torch.nn.BatchNorm2d(6, momentum=0.1)
    ref.load_state_dict(bn.bn.state_dict() | {'running_var': _t(var)})
    ref.train()(_t(x).permute(0, 3, 1, 2))
    assert np.abs(ref.running_var.numpy()
                  - np.asarray(stats['var'])).max() > 1e-2


def test_train_batchnorm_gradient_matches_flax():
    from rtseg_tpu.nn.modules import BatchNorm as FlaxBN
    rng = np.random.RandomState(5)
    x = (1.0 + rng.randn(2, 3, 2, 4)).astype(np.float32)
    w = rng.randn(2, 3, 2, 4).astype(np.float32)
    variables = {'params': {'bn': {'scale': np.full(4, 1.3, np.float32),
                                   'bias': np.zeros(4, np.float32)}},
                 'batch_stats': {'bn': {'mean': np.zeros(4, np.float32),
                                        'var': np.ones(4, np.float32)}}}

    def jloss(xx):
        y, _ = FlaxBN().apply(variables, xx, True, mutable=['batch_stats'])
        return (y * w).sum()
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    y = batch_norm_train(xt.permute(0, 3, 1, 2), torch.full((4,), 1.3),
                         torch.zeros(4), torch.zeros(4), torch.ones(4))
    (y.permute(0, 2, 3, 1) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gj, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ train loader

def test_train_loader_matches_jax_loader_over_two_epochs():
    """Same samples in the same shuffled order, ragged tail dropped, for
    two epochs, as the JAX package's ShardedLoader(shuffle=True,
    drop_last=True)."""
    from rtseg_tpu.data.loader import ShardedLoader
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    from rtseg_tpu_torch.data import get_loader
    kw = dict(dataset='synthetic', num_class=NC, crop_h=16, crop_w=24,
              synthetic_len=11, train_bs=3, random_seed=7, total_epoch=2)
    cfg = SegConfig(base_workers=2, **kw)
    cfg.resolve(num_devices=1)
    loader, _ = get_loader(cfg)
    assert cfg.train_num == 9 and cfg.total_itrs == 6
    jcfg = JaxSegConfig(**kw)
    jloader = ShardedLoader(JaxSynthetic(jcfg, mode='train'), 3, seed=7,
                            shuffle=True, drop_last=True)
    orders = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        ours, theirs = list(loader), list(jloader)
        assert len(ours) == len(theirs) == 3
        for (ti, tm), (ji, jm) in zip(ours, theirs):
            assert tm.dtype == torch.int32 and ti.is_contiguous()
            np.testing.assert_array_equal(ti.numpy(), ji)
            np.testing.assert_array_equal(tm.numpy(), jm)
        orders.append(np.concatenate([m.numpy().ravel() for _, m in ours]))
    assert not np.array_equal(orders[0], orders[1])   # reshuffled
