"""PyTorch port against the JAX package: Lite-HRNet (logits at 1/4) at its
registry default, litehrnet18, on a small input, with the checks of
tests/test_torch_resnet_models.py: parameter paths equal to the Flax init
tree's (also at litehrnet30, whose tree alone is compared), eval logits
within 1e-4 deferred and not, a training forward's outputs and
batch_stats against the Flax model run in float64, and the bf16 logits'
type; its shuffle block and one stage alone.

Its spatial weights normalize a global average and its cross-resolution
weights a map pooled to 1/32 (2 x 4 on the 64 x 128 input): in training
those BatchNorms see one value (eight) a sample and channel, as
ill-conditioned as FPENet's channel gate; the float64 comparison of
`assert_near_float64` allows for the Flax model's own float32 run there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.models.lite_hrnet import (ARCH_HUB, LiteHRNet,
                                               ShuffleBlock, StageBlock)
from rtseg_tpu_torch.utils.convert import _flatten, to_jax_variables
from test_torch_backbone import _check_against_flax
from test_torch_gated_models import check_bf16_logits
from test_torch_resnet_models import (NC, H, W, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parameter_paths_equal_the_flax_init_tree():
    check_parameter_paths('lite_hrnet')


def test_litehrnet30_parameter_paths_equal_the_flax_init_tree():
    """litehrnet30 (3, 8, 3 modules a stage): the pinned names `crw{i}`,
    `ccw{i}_{j}_{r}`, `fusion{i}` and the fusion's `s*_*` at the deeper
    hub entry."""
    from rtseg_tpu.models.lite_hrnet import LiteHRNet as FlaxLiteHRNet
    assert ARCH_HUB == {'litehrnet18': (2, 4, 2), 'litehrnet30': (3, 8, 3)}
    tree = jax.eval_shape(lambda: FlaxLiteHRNet(
        num_class=NC, arch_type='litehrnet30').init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))
    want = {k: tuple(v.shape) for k, v in _flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    got = {k: tuple(v.shape) for k, v in _flatten(to_jax_variables(
        LiteHRNet(NC, arch_type='litehrnet30'))).items()}
    assert got == want
    assert ('params', 'StageBlock_1', 'fusion7', 's3_down', 'DSConvBNAct_0',
            'PWConvBNAct_0', 'Conv_0', 'conv', 'kernel') in got


@pytest.mark.parametrize('defer', [False, True])
def test_eval_logits_match_flax(defer):
    check_eval_logits('lite_hrnet', defer)


def test_training_forward_and_batch_stats_match_flax():
    check_training_forward('lite_hrnet')


def test_bf16_logits_take_the_flax_models_type():
    check_bf16_logits('lite_hrnet')


@pytest.mark.parametrize('cin,cout,stride', [(32, 40, 2), (40, 40, 1)])
def test_shuffle_block_matches_flax(cin, cout, stride):
    """With a stride or a new width the left half goes through a 1x1
    ConvBNAct; else it is kept, and the right half's modules take the
    first names."""
    from rtseg_tpu.models.lite_hrnet import ShuffleBlock as FlaxShuffleBlock
    x = np.random.RandomState(cin).uniform(
        -1.5, 1.5, (2, 16, 24, cin)).astype(np.float32)
    _check_against_flax(ShuffleBlock(cin, cout, stride),
                        FlaxShuffleBlock(cout, stride), x, seed=stride)


def test_stage_block_matches_flax():
    """One two-branch stage of one module: cross-resolution weights, CCW
    blocks and the fusion with its extra (third) output, against the Flax
    stage on the same two inputs."""
    from rtseg_tpu.models.lite_hrnet import StageBlock as FlaxStageBlock
    from test_torch_backbone import assert_near_float64
    from rtseg_tpu_torch.utils.convert import (load_jax_variables,
                                               random_jax_variables)
    rs = np.random.RandomState(0)
    feats = [rs.uniform(-1.5, 1.5, (4, 16, 16, 16)).astype(np.float32),
             rs.uniform(-1.5, 1.5, (4, 8, 8, 32)).astype(np.float32)]
    fmodule = FlaxStageBlock(16, 2, 1, 1)
    module = StageBlock(16, 2, 1, 1)
    tree = jax.eval_shape(lambda: fmodule.init(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats], False))
    want = {k: tuple(v.shape) for k, v in _flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    assert {k: tuple(v.shape) for k, v in
            _flatten(to_jax_variables(module)).items()} == want
    v = random_jax_variables(module, seed=4)
    load_jax_variables(module, v)
    xt = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    wanted = jax.jit(lambda v, f: fmodule.apply(v, f, False))(
        jax.tree.map(jnp.asarray, v), [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = module.eval()(xt)
    assert len(got) == len(wanted) == 3
    for g, w in zip(got, wanted):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=1e-4, rtol=1e-4)
    run = {}
    for dt in (jnp.float32, jnp.float64):
        with jax.enable_x64(dt == jnp.float64):
            o, mut = jax.jit(lambda v, f: fmodule.apply(
                v, f, True, mutable=['batch_stats']))(
                jax.tree.map(lambda a: jnp.asarray(a, dt), v),
                [jnp.asarray(f, dt) for f in feats])
            run[dt] = jax.device_get((o, mut['batch_stats']))
    (o32, bs32), (o64, bs64) = run[jnp.float32], run[jnp.float64]
    with torch.no_grad():
        got = module.train()(xt)
    for i, g in enumerate(got):
        assert_near_float64(g.permute(0, 2, 3, 1).numpy(), o64[i], o32[i],
                            f'output {i}')
    got_bs = dict(_flatten(to_jax_variables(module)['batch_stats']))
    bs32, bs64 = dict(_flatten(bs32)), dict(_flatten(bs64))
    assert got_bs.keys() == bs64.keys()
    for k in bs64:
        assert_near_float64(got_bs[k], bs64[k], bs32[k], '/'.join(k))


def test_unknown_architecture_raises():
    with pytest.raises(ValueError, match='litehrnet'):
        LiteHRNet(NC, arch_type='litehrnet50')
