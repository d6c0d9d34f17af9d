"""PyTorch port against the JAX package: FastSCNN, DDRNet-23-slim (with
and without its aux head) and STDC1 (plain, with three aux heads, with the
detail head), at full width on a small input.

For each variant the port's parameter paths and shapes equal the Flax init
tree's; the same seeded Flax-shaped variables (made with numpy by the
port) then drive the Flax model and the port's model: float32 eval logits,
deferred and full-size, within 1e-4 of the Flax model's; one training
forward's outputs and updated batch_stats within 1e-4 of the Flax model run
in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.utils.convert import (_flatten, load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)

NC, H, W = 19, 64, 128
VARIANTS = {
    'fastscnn': dict(model='fastscnn'),
    'ddrnet': dict(model='ddrnet'),
    'ddrnet_aux': dict(model='ddrnet', use_aux=True),
    'stdc': dict(model='stdc'),
    'stdc_aux': dict(model='stdc', use_aux=True),
    'stdc_detail': dict(model='stdc', use_detail_head=True),
}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(variant):
    return {'use_aux': False, 'num_class': NC, **VARIANTS[variant]}


def _flax_model(variant):
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    return jax_get_model(JaxSegConfig(**_kw(variant)))


def _port_model(variant, variables):
    model = get_model(SegConfig(**_kw(variant)))
    load_jax_variables(model, variables)
    return model


def _input(seed=42, n=2):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (n, H, W, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def variables():
    return {v: random_jax_variables(get_model(SegConfig(**_kw(v))), seed=i)
            for i, v in enumerate(VARIANTS)}


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_parameter_paths_equal_the_flax_init_tree(variant):
    model = get_model(SegConfig(**_kw(variant)))
    fmodel = _flax_model(variant)
    tree = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))
    want = {k: tuple(v.shape) for k, v in _flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    got = {k: tuple(v.shape)
           for k, v in _flatten(to_jax_variables(model)).items()}
    assert got == want
    if variant == 'stdc_detail':
        # materialized by the Flax init although the forward never calls it
        assert got[('params', 'detail_conv', 'conv', 'kernel')] == \
            (1, 1, 3, 1)


@pytest.mark.parametrize('defer', [False, True])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_eval_logits_match_flax(variables, variant, defer):
    from rtseg_tpu.ops import set_defer_final_upsample
    x = _input()
    fmodel = _flax_model(variant)
    try:
        set_defer_final_upsample(defer)
        want = np.asarray(jax.jit(lambda v, x: fmodel.apply(v, x, False))(
            jax.tree.map(jnp.asarray, variables[variant]), jnp.asarray(x)))
    finally:
        set_defer_final_upsample(False)
    model = _port_model(variant, variables[variant]).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x), defer_upsample=defer)
    hw = (H // 8, W // 8) if defer else (H, W)
    assert tuple(got.shape) == (2,) + hw + (NC,)
    _assert_close(got.numpy(), want, 1e-4, 'logits')


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_training_forward_and_batch_stats_match_flax(variables, variant):
    """The training forward's logits, its aux or detail logits and the
    updated batch_stats within 1e-4 of the Flax twin run in float64.

    Float32 rounding grows through the train-mode BatchNorms, each of
    which renormalizes its input's error along with it: after FastSCNN's
    37 of them the Flax model's own float32 logits lie farther than 1e-4
    from its float64 ones on this input, and the port's float32 logits
    nearer. Against the float64 run the comparison measures the port's
    error alone."""
    x = _input(seed=7, n=4)
    fmodel = _flax_model(variant)
    with jax.enable_x64():
        out, mut = jax.jit(
            lambda v, x: fmodel.apply(v, x, True, mutable=['batch_stats']))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         variables[variant]), jnp.asarray(x, jnp.float64))
        assert jax.tree.leaves(out)[0].dtype == jnp.float64
        out, mut = jax.device_get((out, mut))
    model = _port_model(variant, variables[variant]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    kw = _kw(variant)
    if kw['use_aux'] or kw.get('use_detail_head'):
        (got, got_extra), (out, extra) = got, out
        if kw['use_aux']:
            assert isinstance(got_extra, tuple)
            assert len(got_extra) == len(extra) == \
                {'ddrnet': 1, 'stdc': 3}[kw['model']]
        else:
            got_extra, extra = (got_extra,), (extra,)
            assert tuple(got_extra[0].shape) == (4, H // 8, W // 8, 1)
        for i, (g, e) in enumerate(zip(got_extra, extra)):
            _assert_close(g.numpy(), e, 1e-4, f'extra output {i}')
    _assert_close(got.numpy(), out, 1e-4, 'logits')
    got_bs = dict(_flatten(to_jax_variables(model)['batch_stats']))
    want_bs = dict(_flatten(jax.device_get(mut['batch_stats'])))
    assert got_bs.keys() == want_bs.keys()
    for k in want_bs:
        _assert_close(got_bs[k], want_bs[k], 1e-4, '/'.join(k))


def test_registry_dispatch_and_refusals():
    """Beside the cases of tests/test_torch_train_step.py: the detail head
    on the aux models, the TPU remat lever, more unported names."""
    for name, kw in (('ddrnet', dict(use_detail_head=True)),
                     ('bisenetv2', dict(use_detail_head=True))):
        with pytest.raises(ValueError, match='support'):
            get_model(SegConfig(model=name, num_class=NC,
                                **{'use_aux': False, **kw}))
    for name in ('ddrnet', 'stdc'):
        with pytest.raises(NotImplementedError, match='hires_remat'):
            get_model(SegConfig(model=name, num_class=NC, use_aux=False,
                                hires_remat=True))
    for name in ('enet', 'segnet', 'cgnet'):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            get_model(SegConfig(model=name, num_class=NC, use_aux=False))


def test_detail_targets_match_flax(variables):
    """STDC's detail targets (its detail_conv over the Laplacian pyramid of
    masks with ignore pixels) against the Flax model's detail_targets: the
    values within float32 rounding of the largest term (about 2e3 x 0.6),
    and the thresholded targets the train step uses equal."""
    from rtseg_tpu.losses import laplacian_pyramid as jax_pyramid
    rs = np.random.RandomState(11)
    masks = rs.randint(0, NC, (2, H, W)).astype(np.int32)
    masks[rs.uniform(size=masks.shape) < 0.1] = 255
    pyr = np.asarray(jax_pyramid(jnp.asarray(masks)))
    v = variables['stdc_detail']
    want = np.asarray(_flax_model('stdc_detail').apply(
        {'params': jax.tree.map(jnp.asarray, v['params'])},
        jnp.asarray(pyr), method='detail_targets'))
    model = _port_model('stdc_detail', v)
    with torch.no_grad():
        got = model.detail_targets(torch.from_numpy(pyr)).numpy()
    assert got.shape == want.shape == (2, H, W, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(got > 0.1, want > 0.1)
