"""PyTorch port against the JAX package: the ResNet and MobileNetV2
backbones, DeConvBNAct, pixel_shuffle, adaptive_max_pool, and the
converter's rules, keyed on the module type (transposed convs, Dense
layers under any name, strictness, checkpoint momentum buffers).

Backbones run at their published widths on a small input: ResNet-18,
ICNet's dilated ResNet-18 (dilations 1, 1, 2, 4), MobileNetV2, and the
Bottleneck block (ResNet-50 and deeper) at a small width beside
ResNet-50's parameter tree. For each, the port's parameter paths equal the
Flax init tree's; the same seeded Flax-shaped variables drive both: eval
features within 1e-4 of Flax's, and one training forward's features and
updated batch_stats within 1e-4 of the Flax module run in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.models.backbone import (Bottleneck, Mobilenetv2,
                                             ResNet)
from rtseg_tpu_torch.nn import DeConvBNAct
from rtseg_tpu_torch.ops.pool import adaptive_max_pool
from rtseg_tpu_torch.ops.resize import pixel_shuffle, pixel_shuffle_nchw
from rtseg_tpu_torch.utils.convert import (_flatten, from_jax_variables,
                                           load_jax_variables,
                                           random_jax_variables,
                                           state_dict_to_flax,
                                           to_jax_variables)

H, W = 64, 96


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(shape, seed=42):
    return np.random.RandomState(seed).uniform(-1.5, 1.5, shape).astype(
        np.float32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _flax_tree(fmodule, x):
    tree = jax.eval_shape(lambda: fmodule.init(
        jax.random.PRNGKey(0), jnp.asarray(x), False))
    return {k: tuple(v.shape) for k, v in _flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree)).items()}


def _err(got, want):
    """The smallest tol at which np.allclose(got, want, atol=tol,
    rtol=tol) holds."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((np.abs(got - want) / (1.0 + np.abs(want))).max())


def assert_near_float64(got, want64, want32, what, tol=1e-4):
    """The port's float32 value within `tol` of the Flax float64 run's,
    or, where the Flax float32 run itself lies farther than `tol` from
    it, no farther than that run. Float32 rounding grows through
    train-mode BatchNorms over few values a channel (MobileNetV2's 1/32
    stage sees 2 x 2 x 3 values on the small input); no float32
    implementation holds 1e-4 there."""
    err = _err(got, want64)
    assert err <= max(tol, _err(want32, want64)), (what, err,
                                                   _err(want32, want64))


def flax_train_forward(fmodule, variables, x, *args):
    """{dtype: (outputs, batch_stats)} of one training forward of the
    Flax module on the float32 and on the float64 variables and input."""
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            o, mut = jax.jit(lambda v, x: fmodule.apply(
                v, x, True, *args, mutable=['batch_stats']))(
                jax.tree.map(lambda a: jnp.asarray(a, dtype), variables),
                jnp.asarray(x, dtype))
            assert jax.tree.leaves(o)[0].dtype == dtype
            out[dtype] = jax.device_get((o, mut['batch_stats']))
    return out[jnp.float32], out[jnp.float64]


def _check_against_flax(module, fmodule, x, seed=0):
    """Parameter tree, eval outputs within 1e-4, and a training forward's
    outputs and batch_stats against the Flax float64 run
    (`assert_near_float64`). `x` is NHWC."""
    got = {k: tuple(v.shape)
           for k, v in _flatten(to_jax_variables(module)).items()}
    assert got == _flax_tree(fmodule, x)
    variables = random_jax_variables(module, seed=seed)
    load_jax_variables(module, variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    want = jax.jit(lambda v, x: fmodule.apply(v, x, False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        out = module.eval()(xt)
    want, out = (w if isinstance(w, tuple) else (w,) for w in (want, out))
    assert len(out) == len(want)
    for i, (g, w) in enumerate(zip(out, want)):
        _assert_close(_nhwc(g), w, 1e-4, f'eval output {i}')

    (out32, bs32), (out64, bs64) = flax_train_forward(fmodule, variables, x)
    with torch.no_grad():
        out = module.train()(xt)
    out, out32, out64 = (o if isinstance(o, tuple) else (o,)
                         for o in (out, out32, out64))
    for i, g in enumerate(out):
        assert_near_float64(_nhwc(g), out64[i], out32[i],
                            f'training output {i}')
    got_bs = dict(_flatten(to_jax_variables(module)['batch_stats']))
    bs32, bs64 = dict(_flatten(bs32)), dict(_flatten(bs64))
    assert got_bs.keys() == bs64.keys()
    for k in bs64:
        assert_near_float64(got_bs[k], bs64[k], bs32[k], '/'.join(k))


# ------------------------------------------------------------- backbones

@pytest.mark.parametrize('dilations', [(1, 1, 1, 1), (1, 1, 2, 4)],
                         ids=['resnet18', 'resnet18_dilated'])
def test_resnet18_matches_flax(dilations):
    from rtseg_tpu.models.backbone import ResNet as FlaxResNet
    module = ResNet('resnet18', dilations)
    assert module.channels == (64, 128, 256, 512)
    _check_against_flax(module, FlaxResNet('resnet18', dilations),
                        _input((2, H, W, 3)))
    if dilations[2] > 1:
        # ICNet's surgical dilation: only block 0's first 3x3 is dilated
        assert module.layer3_0.conv1.conv.dilation == (2, 2)
        assert module.layer3_0.conv2.conv.dilation == (1, 1)
        assert module.layer3_1.conv1.conv.dilation == (1, 1)
        assert module.layer4_0.conv1.conv.dilation == (4, 4)
        assert module.layer4_0.conv1.conv.stride == (1, 1)
        assert module.layer4_0.downsample_conv.conv.stride == (1, 1)


def test_mobilenetv2_matches_flax():
    from rtseg_tpu.models.backbone import Mobilenetv2 as FlaxMobilenetv2
    module = Mobilenetv2()
    _check_against_flax(module, FlaxMobilenetv2(), _input((2, H, W, 3)),
                        seed=1)
    # block1 (expand ratio 1) has no expand conv; residuals where allowed
    assert not hasattr(module.block1, 'expand')
    assert [module.get_submodule(f'block{i}').use_res
            for i in (2, 3, 4, 5)] == [False, True, False, True]


def test_resnet_stops_after_the_stages_asked_for():
    """ResNet(x, stages) returns the first `stages` features of the full
    call, bit for bit (ICNet's eval-time second call stops after layer2)."""
    torch.manual_seed(0)
    module = ResNet('resnet18', (1, 1, 2, 4)).eval()
    x = torch.from_numpy(_input((2, H, W, 3))).permute(0, 3, 1, 2)
    with torch.no_grad():
        full, part = module(x), module(x, 2)
    assert len(full) == 4 and len(part) == 2
    for a, b in zip(part, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize('in_c,channels,stride,dilation',
                         [(16, 8, 2, 1), (32, 8, 1, 1), (32, 8, 1, 2)],
                         ids=['strided', 'identity', 'dilated'])
def test_bottleneck_block_matches_flax(in_c, channels, stride, dilation):
    """The Bottleneck block of ResNet-50 and deeper, at a small width: a
    downsample branch where the stride or the width asks for one, the
    plain residual otherwise."""
    from rtseg_tpu.models.backbone import Bottleneck as FlaxBottleneck
    module = Bottleneck(in_c, channels, stride, dilation)
    assert module.down == (stride != 1 or in_c != 4 * channels)
    _check_against_flax(module, FlaxBottleneck(channels, stride, dilation),
                        _input((4, 16, 24, in_c)), seed=2)


def test_resnet50_parameter_tree_equals_flax():
    from rtseg_tpu.models.backbone import ResNet as FlaxResNet
    module = ResNet('resnet50')
    got = {k: tuple(v.shape)
           for k, v in _flatten(to_jax_variables(module)).items()}
    assert got == _flax_tree(FlaxResNet('resnet50'),
                             np.zeros((1, 32, 32, 3), np.float32))
    assert module.channels == (256, 512, 1024, 2048)
    with pytest.raises(ValueError, match='Unsupported ResNet'):
        ResNet('resnet20')


# ----------------------------------------------------------- DeConvBNAct

# (scale, kernel, output_padding): the default 2x (ShelfNet, LinkNet,
# CANet's context branch), CANet's 8x head (kernel 15), and a torch-style
# k4/s2 block with output_padding 0
@pytest.mark.parametrize('scale,kernel,out_pad',
                         [(2, None, None), (8, None, None), (2, 4, 0)],
                         ids=['x2', 'x8_k15', 'x2_k4_op0'])
def test_deconv_bn_act_matches_flax(scale, kernel, out_pad):
    from rtseg_tpu.nn.modules import DeConvBNAct as FlaxDeConvBNAct
    module = DeConvBNAct(6, 5, scale, kernel, 'relu', out_pad)
    k = kernel or 2 * scale - 1
    assert module.deconv.weight.shape == (6, 5, k, k)
    x = _input((2, 7, 9, 6), seed=3)
    _check_against_flax(module, FlaxDeConvBNAct(5, scale, kernel, 'relu',
                                                out_pad), x, seed=3)
    with torch.no_grad():
        y = module.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(y.shape[2:]) == (7 * scale, 9 * scale)


def test_deconv_bn_act_runs_bf16_with_float32_weights():
    module = DeConvBNAct(4, 3).eval()
    x = torch.from_numpy(_input((1, 4, 5, 6))).to(torch.bfloat16)
    with torch.no_grad():
        y = module(x)
        want = module(x.float())
    assert y.dtype == torch.bfloat16
    assert module.deconv.weight.dtype == torch.float32
    _assert_close(y.float().numpy(), want.numpy(), 3e-2, 'bf16 deconv')


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize('r', [2, 4])
def test_pixel_shuffle_matches_jax_and_torch(r):
    from rtseg_tpu.ops.resize import pixel_shuffle as jax_pixel_shuffle
    x = _input((2, 5, 7, 3 * r * r), seed=r)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), r))
    got = pixel_shuffle(torch.from_numpy(x), r).numpy()
    assert got.shape == (2, 5 * r, 7 * r, 3)
    np.testing.assert_array_equal(got, want)
    # NCHW form: torch's own op's order, and channels_last kept
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    y = pixel_shuffle_nchw(xt, r)
    np.testing.assert_array_equal(
        y.numpy(), torch.nn.functional.pixel_shuffle(xt.contiguous(),
                                                     r).numpy())
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize('out', [1, 2, 3], ids=['global', 'uniform',
                                                'ragged'])
def test_adaptive_max_pool_values_and_gradient_with_ties(out):
    """Values equal to the JAX package's; the gradient at tied maxima
    split evenly among them, as jax.grad of the JAX pool gives it (torch's
    F.adaptive_max_pool2d would send it to one index)."""
    from rtseg_tpu.ops.pool import adaptive_max_pool as jax_pool
    rs = np.random.RandomState(out)
    # few distinct values: most windows hold several equal maxima
    x = rs.randint(0, 3, (2, 6, 8, 3)).astype(np.float32)
    cot = rs.uniform(0.5, 1.5, (2, out, out, 3)).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), out))
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_pool(a, out) * cot))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = adaptive_max_pool(xt, out)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-6,
                               atol=1e-7)
    # ties are present: the single-index form gives another gradient
    xs = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    single = torch.nn.functional.adaptive_max_pool2d(xs, out)
    (single * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert not np.allclose(xs.grad.permute(0, 2, 3, 1).numpy(), want_grad)


# ------------------------------------------------------- the converter

class _Named(torch.nn.Module):
    """Modules under arbitrary names: a Linear, a transposed conv, a conv
    and a BatchNorm, the converter's rules found by their types alone."""

    def __init__(self, names):
        super().__init__()
        dense, deconv, conv, bn = names
        setattr(self, dense, torch.nn.Linear(6, 2))
        setattr(self, deconv, torch.nn.ConvTranspose2d(4, 5, 3))
        setattr(self, conv, torch.nn.Conv2d(3, 4, (3, 2), bias=False))
        setattr(self, bn, torch.nn.BatchNorm2d(4))


@pytest.mark.parametrize('names', [
    ('ca_fc', 'deconv', 'conv', 'bn'),             # the old name-keyed rules
    ('Dense_0', 'up', 'proj2', 'norm'),
    ('glo1', 'Dense_1', 'loc', 'BatchNorm_0'),
    ('deconv', 'conv', 'ca_fc', 'glo2'),           # names of other rules
], ids=['old_names', 'auto_names', 'cgnet_names', 'swapped_names'])
def test_deconv_and_dense_rules_and_round_trip(names):
    """Rules keyed on the module type: a transposed conv's (kh, kw, out,
    in) kernel goes to torch's (in, out, kh, kw), a Dense (in, out) to
    Linear's (out, in) and a conv's HWIO to OIHW, whatever the modules
    are called; state_dict_to_flax maps each back exactly, and the torch
    layouts compute what the Flax layouts do."""
    dense, deconv, conv, bn = names
    module = _Named(names)
    rs = np.random.RandomState(0)
    variables = {'params': {
        deconv: {'kernel': rs.uniform(-1, 1, (3, 3, 5, 4)),
                 'bias': np.arange(5.0)},
        dense: {'kernel': rs.uniform(-1, 1, (6, 2)), 'bias': np.ones(2)},
        conv: {'kernel': rs.uniform(-1, 1, (3, 2, 3, 4))},
        bn: {'scale': rs.uniform(0.5, 1.5, 4), 'bias': np.zeros(4)}},
        'batch_stats': {bn: {'mean': rs.uniform(-1, 1, 4),
                             'var': rs.uniform(0.5, 2, 4)}}}
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    sd = from_jax_variables(variables, module)
    np.testing.assert_array_equal(sd[f'{deconv}.weight'].numpy(),
                                  variables['params'][deconv]['kernel']
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd[f'{dense}.weight'].numpy(),
                                  variables['params'][dense]['kernel'].T)
    np.testing.assert_array_equal(sd[f'{conv}.weight'].numpy(),
                                  variables['params'][conv]['kernel']
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd[f'{bn}.running_var'].numpy(),
                                  variables['batch_stats'][bn]['var'])
    load_jax_variables(module, variables)
    back = dict(_flatten(to_jax_variables(module)))
    want = dict(_flatten(variables))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)
    # the Dense computes the same on both sides
    g = rs.uniform(-1, 1, (3, 6)).astype(np.float32)
    layer = getattr(module, dense)
    np.testing.assert_allclose(
        layer(torch.from_numpy(g)).detach().numpy(),
        g @ variables['params'][dense]['kernel'] + 1.0, rtol=1e-6,
        atol=1e-6)


def _strict_cases():
    k4 = np.zeros((3, 3, 4, 5), np.float32)
    k2 = np.zeros((6, 2), np.float32)
    names = ('fc', 'up', 'conv', 'bn')
    return [
        # a kernel whose rank is not its module's
        ({'params': {'conv': {'kernel': k2}}}, ValueError, '4-D Conv2d'),
        ({'params': {'up': {'kernel': k2}}}, ValueError,
         '4-D ConvTranspose2d'),
        ({'params': {'fc': {'kernel': k4}}}, ValueError, '2-D Linear'),
        # a leaf the module's type has no rule for
        ({'params': {'fc': {'scale': np.ones(2)}}}, KeyError,
         'unmapped Flax leaf.*Linear has no such leaf'),
        ({'batch_stats': {'conv': {'mean': np.ones(4)}}}, KeyError,
         'unmapped Flax leaf'),
        # a scope that names no module
        ({'params': {'Dense_0': {'kernel': k2}}}, KeyError,
         "no module named 'Dense_0'"),
        ({'params': {'kernel': k2}}, KeyError, 'unmapped Flax leaf'),
        # a module of a type without a rule (torch's own GroupNorm: the
        # rule is the port's GroupNorm's, keyed on the exact type)
        ({'params': {'ln': {'scale': np.ones(4)}}}, KeyError,
         'unknown module type GroupNorm'),
    ], names


@pytest.mark.parametrize('case', range(8))
def test_converter_stays_strict_on_kernel_ranks_and_names(case):
    """Strict both ways, with no name in the rules: a kernel of another
    rank than its module's, a leaf or a module type without a rule, a
    scope that names no module, and a module tensor without a Flax leaf
    raise; loading leaves no module tensor unfilled."""
    cases, names = _strict_cases()
    module = _Named(names)
    module.ln = torch.nn.GroupNorm(2, 4)
    variables, error, match = cases[case]
    with pytest.raises(error, match=match):
        from_jax_variables(variables, module)
    # the other direction
    with pytest.raises(KeyError, match='no Flax leaf'):
        state_dict_to_flax({'fc.weight_v': torch.zeros(2, 2)}, module)
    with pytest.raises(KeyError, match='unknown module type GroupNorm'):
        state_dict_to_flax({'ln.weight': torch.zeros(4)}, module)
    with pytest.raises(KeyError, match="no module named 'nowhere'"):
        state_dict_to_flax({'nowhere.weight': torch.zeros(2, 2)}, module)
    del module.ln
    partial = to_jax_variables(module)
    del partial['batch_stats']
    with pytest.raises(KeyError, match='without a Flax leaf'):
        load_jax_variables(module, partial)


@pytest.mark.parametrize('model,dense', [
    ('cgnet', ('CGBlock_0', 'glo1')),
    ('regseg', ('DBlock_4', 'SEBlock_0', 'Dense_1')),
    ('dfanet', ('backbone2', 'FCAttention_0', 'Dense_0')),
])
def test_dense_leaves_of_the_gated_models_load(model, dense):
    """CGNet's `glo1`/`glo2`, RegSeg's and DFANet's auto-named `Dense_n`
    load with no entry of their own: every leaf of a random Flax tree
    round-trips, and a Dense kernel lands transposed in its Linear."""
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.models import get_model
    module = get_model(SegConfig(model=model, num_class=19, use_aux=False))
    variables = random_jax_variables(module, seed=4)
    load_jax_variables(module, variables)
    back = dict(_flatten(to_jax_variables(module)))
    want = dict(_flatten(variables))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)
    kernel = want[('params',) + dense + ('kernel',)]
    linear = module.get_submodule('.'.join(dense))
    assert isinstance(linear, torch.nn.Linear)
    np.testing.assert_array_equal(linear.weight.detach().numpy(), kernel.T)


@pytest.mark.parametrize('model', ['cgnet', 'sqnet'])
def test_checkpoint_momentum_buffers_round_trip(model, tmp_path):
    """SGD's momentum buffers go to the checkpoint under their Flax paths
    (a Linear's and a transposed conv's transposed as their weights) and
    come back equal: CGNet's Dense gates, SQNet's transposed convs."""
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.train import SegTrainer
    from rtseg_tpu_torch.train.checkpoint import (restore_train_ckpt,
                                                  save_train_ckpt)
    cfg = dict(model=model, num_class=19, use_aux=False, dataset='synthetic',
               crop_h=32, crop_w=64, train_bs=2, val_bs=2, synthetic_len=2,
               compute_dtype='float32', use_tb=False, use_obs=False,
               base_workers=0, save_dir=str(tmp_path))
    trainer = SegTrainer(SegConfig(**cfg), device='cpu')
    imgs, msks = next(iter(trainer.train_loader))
    trainer.state, _ = trainer.train_step(trainer.state, imgs, msks)
    save_train_ckpt(str(tmp_path / 'ck'), trainer.state, 1, 0.5)
    fresh = SegTrainer(SegConfig(**{**cfg, 'save_dir': str(tmp_path / 'b')}),
                       device='cpu')
    assert restore_train_ckpt(str(tmp_path / 'ck'), fresh.state) == (1, 0.5)
    want = {n: trainer.state.optimizer.state[p]['momentum_buffer']
            for n, p in trainer.model.named_parameters()}
    kinds = {type(m) for m in trainer.model.modules()}
    assert (torch.nn.Linear if model == 'cgnet'
            else torch.nn.ConvTranspose2d) in kinds
    for n, p in fresh.model.named_parameters():
        assert torch.equal(fresh.state.optimizer.state[p]['momentum_buffer'],
                           want[n]), n
