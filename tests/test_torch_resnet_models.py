"""PyTorch port against the JAX package: the models built on the ResNet
backbone (BiSeNetv1, ICNet with and without its aux heads, SwiftNet,
FarSeeNet, ShelfNet), at full width on a small input. The LinkNet, LiteSeg
and CANet cases, which end in transposed convs or run on MobileNetV2, are
in tests/test_torch_mobilenet_models.py with the same checks.

For each variant the port's parameter paths and shapes equal the Flax init
tree's; the same seeded Flax-shaped variables (made with numpy by the
port) then drive the Flax model and the port's model: float32 eval logits,
deferred and full-size, within 1e-4 of the Flax model's; one training
forward's outputs and updated batch_stats near the Flax model run in
float64 (`test_torch_backbone.assert_near_float64`: within 1e-4, or no
farther than the Flax model's own float32 run where that run lies
farther).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import PORTED, get_model
from rtseg_tpu_torch.utils.convert import (_flatten, load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)
from test_torch_backbone import assert_near_float64, flax_train_forward

NC, H, W = 19, 64, 128
# variant -> (config switches, output stride of the deferred logits)
MODELS = {
    'bisenetv1': (dict(model='bisenetv1'), 8),
    'icnet_aux': (dict(model='icnet', use_aux=True), 4),
    'icnet': (dict(model='icnet'), 4),
    'swiftnet': (dict(model='swiftnet'), 4),
    'farseenet': (dict(model='farseenet'), 4),
    'shelfnet': (dict(model='shelfnet'), 4),
    'linknet': (dict(model='linknet'), 1),
    'liteseg': (dict(model='liteseg'), 8),
    'canet': (dict(model='canet'), 1),
    # PP-LiteSeg and the InitialBlock-stem models
    # (tests/test_torch_ppliteseg.py, tests/test_torch_stem_models.py)
    'ppliteseg': (dict(model='ppliteseg'), 8),
    'cfpnet': (dict(model='cfpnet'), 8),
    'dabnet': (dict(model='dabnet'), 8),
    'mininetv2': (dict(model='mininetv2'), 2),
    'erfnet': (dict(model='erfnet'), 1),
    'esnet': (dict(model='esnet'), 1),
    'fddwnet': (dict(model='fddwnet'), 1),
    'fssnet': (dict(model='fssnet'), 1),
}
VARIANTS = ('bisenetv1', 'icnet_aux', 'icnet', 'swiftnet', 'farseenet',
            'shelfnet')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(variant):
    return {'use_aux': False, 'num_class': NC, **MODELS[variant][0]}


def flax_model(variant):
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    return jax_get_model(JaxSegConfig(**_kw(variant)))


@lru_cache(maxsize=None)
def variables(variant):
    return random_jax_variables(get_model(SegConfig(**_kw(variant))),
                                seed=list(MODELS).index(variant))


def port_model(variant):
    model = get_model(SegConfig(**_kw(variant)))
    load_jax_variables(model, variables(variant))
    return model


def _input(seed=42, n=2):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (n, H, W, 3)).astype(np.float32)


def check_parameter_paths(variant):
    model = get_model(SegConfig(**_kw(variant)))
    fmodel = flax_model(variant)
    tree = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))
    want = {k: tuple(v.shape) for k, v in _flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    got = {k: tuple(v.shape)
           for k, v in _flatten(to_jax_variables(model)).items()}
    assert got == want


def check_eval_logits(variant, defer):
    from rtseg_tpu.ops import set_defer_final_upsample
    x = _input()
    fmodel = flax_model(variant)
    try:
        set_defer_final_upsample(defer)
        want = np.asarray(jax.jit(lambda v, x: fmodel.apply(v, x, False))(
            jax.tree.map(jnp.asarray, variables(variant)), jnp.asarray(x)))
    finally:
        set_defer_final_upsample(False)
    model = port_model(variant).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x), defer_upsample=defer)
    stride = MODELS[variant][1] if defer else 1
    assert tuple(got.shape) == (2, H // stride, W // stride, NC)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def check_training_forward(variant):
    """The training forward's logits, aux logits and updated batch_stats
    against the Flax twin run in float64."""
    x = _input(seed=7, n=4)
    (out32, bs32), (out64, bs64) = flax_train_forward(
        flax_model(variant), variables(variant), x)
    model = port_model(variant).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if _kw(variant)['use_aux']:
        (got, got_aux), (out32, aux32), (out64, aux64) = got, out32, out64
        assert isinstance(got_aux, tuple) and len(got_aux) == len(aux64) == 2
        # ICNet's aux heads: after cff42 at 1/16, after cff21 at 1/8
        assert [tuple(a.shape[1:3]) for a in got_aux] == \
            [(H // 16, W // 16), (H // 8, W // 8)]
        for i, g in enumerate(got_aux):
            assert_near_float64(g.numpy(), aux64[i], aux32[i], f'aux {i}')
    assert_near_float64(got.numpy(), out64, out32, 'logits')
    got_bs = dict(_flatten(to_jax_variables(model)['batch_stats']))
    bs32, bs64 = dict(_flatten(bs32)), dict(_flatten(bs64))
    assert got_bs.keys() == bs64.keys()
    for k in bs64:
        assert_near_float64(got_bs[k], bs64[k], bs32[k], '/'.join(k))


@pytest.mark.parametrize('variant', VARIANTS)
def test_parameter_paths_equal_the_flax_init_tree(variant):
    check_parameter_paths(variant)


@pytest.mark.parametrize('defer', [False, True])
@pytest.mark.parametrize('variant', VARIANTS)
def test_eval_logits_match_flax(variant, defer):
    check_eval_logits(variant, defer)


@pytest.mark.parametrize('variant', VARIANTS)
def test_training_forward_and_batch_stats_match_flax(variant):
    check_training_forward(variant)


def test_icnet_runs_its_backbone_twice_in_order():
    """ICNet calls one backbone on the 1/4 input, then on the 1/2 input,
    and both calls run all four stages. Flax updates the running
    statistics on each call in turn, so after one training forward every
    backbone BatchNorm holds two updates: equal to the Flax model's, and
    for layer3 and layer4 (unused by the second call's output) different
    from what the first call alone leaves."""
    variant = 'icnet_aux'
    x = _input(seed=7, n=4)
    (_, bs32), (_, bs64) = flax_train_forward(flax_model(variant),
                                              variables(variant), x)
    model = port_model(variant).train()
    backbone = model.backbone
    calls = []
    backbone.register_forward_hook(
        lambda m, args, out: calls.append((tuple(args[0].shape[2:]),
                                           len(out))))
    with torch.no_grad():
        model(torch.from_numpy(x))
    assert calls == [((H // 4, W // 4), 4), ((H // 2, W // 2), 4)]
    got = dict(_flatten(to_jax_variables(model)['batch_stats']['backbone']))
    bs32 = dict(_flatten(bs32['backbone']))
    bs64 = dict(_flatten(bs64['backbone']))
    assert got.keys() == bs64.keys()
    for k in bs64:
        assert_near_float64(got[k], bs64[k], bs32[k], '/'.join(k))

    # one call on the 1/4 input alone leaves other layer3/layer4 stats
    once = port_model(variant).train()
    x4 = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), (H // 4, W // 4),
        mode='bilinear', align_corners=True)
    with torch.no_grad():
        once.backbone(x4)
    once = dict(_flatten(to_jax_variables(once)['batch_stats']['backbone']))
    for k in bs64:
        if k[0].startswith(('layer3', 'layer4')):
            assert not np.allclose(once[k], bs64[k], atol=1e-3, rtol=1e-3), k


def test_icnet_eval_stops_its_second_backbone_call_after_layer2():
    """Out of training layer3 and layer4 move no running statistics, so
    ICNet's second backbone call (on the 1/2 input) stops after layer2;
    its eval logits are held to Flax by test_eval_logits_match_flax."""
    model = port_model('icnet').eval()
    calls = []
    model.backbone.register_forward_hook(
        lambda m, args, out: calls.append((tuple(args[0].shape[2:]),
                                           len(out))))
    with torch.inference_mode():
        model(torch.from_numpy(_input()))
    assert calls == [((H // 4, W // 4), 4), ((H // 2, W // 2), 2)]


def test_registry_builds_the_backbone_family_and_refuses_the_rest():
    """The eight names build at the JAX registry's defaults (ResNet-18,
    or MobileNetV2 for LiteSeg and CANet); ICNet takes use_aux; the others
    refuse aux and detail heads with the JAX registry's ValueErrors."""
    from rtseg_tpu_torch.models.backbone import Mobilenetv2, ResNet
    names = ('bisenetv1', 'icnet', 'swiftnet', 'farseenet', 'shelfnet',
             'linknet', 'liteseg', 'canet')
    assert set(names) <= set(PORTED) and len(PORTED) == 20
    for name in names:
        model = get_model(SegConfig(model=name, num_class=NC,
                                    use_aux=name == 'icnet'))
        kinds = {type(m) for m in model.modules()} & {ResNet, Mobilenetv2}
        assert kinds == ({Mobilenetv2} if name in ('liteseg', 'canet')
                         else {ResNet}), name
        if name == 'icnet':
            assert model.use_aux
            assert not get_model(SegConfig(model=name, num_class=NC,
                                           use_aux=False)).use_aux
            continue
        with pytest.raises(ValueError, match='auxiliary heads'):
            get_model(SegConfig(model=name, num_class=NC, use_aux=True))
        with pytest.raises(ValueError, match='detail heads'):
            get_model(SegConfig(model=name, num_class=NC, use_aux=False,
                                use_detail_head=True))
    with pytest.raises(ValueError, match='detail heads'):
        get_model(SegConfig(model='icnet', num_class=NC,
                            use_detail_head=True))
