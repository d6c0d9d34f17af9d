"""PyTorch port against the JAX package: the pieces below FastSCNN, DDRNet
and STDC (the adaptive average pool, DSConvBNAct, the pyramid pooling
module) and the STDC detail loss with its Laplacian pyramid.

Inputs are made with numpy from fixed seeds and go through both packages;
the port runs on CPU tensors. Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu.losses import losses as jlosses
from rtseg_tpu.nn import modules as jmodules
from rtseg_tpu.ops import pool as jpool

from rtseg_tpu_torch.losses import (bce_with_logits, detail_loss, dice_loss,
                                    get_detail_loss_fn, laplacian_pyramid)
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.nn import DSConvBNAct, PyramidPoolingModule
from rtseg_tpu_torch.ops.pool import adaptive_avg_pool
from rtseg_tpu_torch.utils.convert import (_flatten, load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- adaptive pool

@pytest.mark.parametrize('shape,out', [
    ((2, 8, 12, 5), (4, 3)),       # uniform windows
    ((2, 16, 32, 7), 1),           # uniform: the global pool
    ((2, 16, 32, 7), 6),           # FastSCNN's PPM at 512x1024: 16x32 -> 6
    ((2, 2, 4, 3), 6),             # at 64x128: 2x4 -> 6, cells overlap
    ((1, 5, 7, 4), (3, 2)),        # odd sizes
])
def test_adaptive_avg_pool_matches_jax(shape, out):
    """float32 within 1e-6; bfloat16 (summed in float32, cast back) equal
    to the JAX package's bfloat16 result to one bf16 ulp."""
    x = np.random.RandomState(0).uniform(-2, 2, shape).astype(np.float32)
    want = np.asarray(jpool.adaptive_avg_pool(jnp.asarray(x), out))
    got = adaptive_avg_pool(torch.from_numpy(x), out)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    want16 = np.asarray(jpool.adaptive_avg_pool(
        jnp.asarray(x, jnp.bfloat16), out).astype(jnp.float32))
    got16 = adaptive_avg_pool(torch.from_numpy(x).to(torch.bfloat16), out)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=2 ** -7,
                               atol=0)


def test_adaptive_avg_pool_gradient_matches_jax():
    x = np.random.RandomState(1).uniform(-2, 2, (2, 5, 7, 3)
                                         ).astype(np.float32)
    w = np.random.RandomState(2).uniform(-1, 1, (2, 6, 6, 3)
                                         ).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jpool.adaptive_avg_pool(a, 6) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (adaptive_avg_pool(xt, 6) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ modules

def _flax_vs_port(fmodule, port, x, train):
    """Outputs (and with train the updated batch_stats) of a Flax module
    and its port from the same seeded variables."""
    variables = random_jax_variables(port, seed=4)
    load_jax_variables(port, variables)
    v = jax.tree.map(jnp.asarray, variables)
    if train:
        want, mut = fmodule.apply(v, jnp.asarray(x), True,
                                  mutable=['batch_stats'])
    else:
        want, mut = fmodule.apply(v, jnp.asarray(x), False), None
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if train:
        got_bs = dict(_flatten(to_jax_variables(port)['batch_stats']))
        want_bs = dict(_flatten(jax.device_get(mut['batch_stats'])))
        assert got_bs.keys() == want_bs.keys()
        for k in want_bs:
            np.testing.assert_allclose(got_bs[k], want_bs[k], atol=1e-5,
                                       rtol=1e-5, err_msg='/'.join(k))


@pytest.mark.parametrize('train', [False, True])
def test_dsconvbnact_matches_flax(train):
    """Outputs and batch_stats within 1e-5, stride 2."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, 12, 16, 8)
                                         ).astype(np.float32)
    _flax_vs_port(jmodules.DSConvBNAct(24, 3, 2),
                  DSConvBNAct(8, 24, 3, 2), x, train)


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('train', [False, True])
def test_pyramid_pooling_module_matches_flax(train, bias):
    """The PPM on a 2x4 map (FastSCNN's 1/32 at 64x128: every pool size
    but 1 and 2 has overlapping cells) and on 5x7; its bare `stage{i}`
    convs and the bias of its fusing conv map path for path. Outputs and
    batch_stats within 1e-5."""
    for shape in ((2, 2, 4, 16), (2, 5, 7, 16)):
        x = np.random.RandomState(5).uniform(-1, 1, shape).astype(np.float32)
        port = PyramidPoolingModule(16, 12, bias=bias)
        _flax_vs_port(jmodules.PyramidPoolingModule(12, bias=bias), port, x,
                      train)
        names = set(dict(port.named_children()))
        assert {'stage1', 'stage2', 'stage3', 'stage4'} <= names
        assert (port.PWConvBNAct_0.Conv_0.conv.bias is not None) == bias


# ------------------------------------------------------------ detail loss

def _detail_inputs(seed=6, shape=(3, 16, 24, 1)):
    rs = np.random.RandomState(seed)
    logits = rs.normal(0, 2, shape).astype(np.float32)
    targets = (rs.uniform(size=shape) > 0.7).astype(np.float32)
    return logits, targets


@pytest.mark.parametrize('name', ['dice_loss', 'bce_with_logits',
                                  'detail_loss'])
def test_detail_losses_match_jax(name):
    """Values and logit gradients within 1e-6 (float32 logits), and the
    value on bf16 logits (computed in float32)."""
    port = {'dice_loss': dice_loss, 'bce_with_logits': bce_with_logits,
            'detail_loss': detail_loss}[name]
    ref = getattr(jlosses, name)
    logits, targets = _detail_inputs()
    want, want_g = jax.value_and_grad(ref)(jnp.asarray(logits),
                                           jnp.asarray(targets))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = port(lt, torch.from_numpy(targets))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6, rtol=1e-6)
    want16 = ref(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets))
    got16 = port(torch.from_numpy(logits).to(torch.bfloat16),
                 torch.from_numpy(targets))
    np.testing.assert_allclose(float(got16), float(want16), atol=1e-6,
                               rtol=1e-6)


def test_detail_loss_fn_takes_the_coefficients():
    logits, targets = _detail_inputs(seed=8)
    cfg = SegConfig(dice_loss_coef=0.3, bce_loss_coef=2.0)
    want = jlosses.detail_loss(jnp.asarray(logits), jnp.asarray(targets),
                               0.3, 2.0)
    got = get_detail_loss_fn(cfg)(torch.from_numpy(logits),
                                  torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('shape', [(2, 32, 48), (3, 37, 53), (1, 5, 9)])
def test_laplacian_pyramid_is_bit_equal_to_jax(shape):
    """Masks of 19 classes with ignore pixels (255) in runs, odd and even
    sizes: the three channels equal the JAX package's bit for bit."""
    rs = np.random.RandomState(9)
    masks = rs.randint(0, 19, shape).astype(np.int32)
    masks[rs.uniform(size=shape) < 0.2] = 255
    masks[:, : shape[1] // 3, : shape[2] // 2] = 255
    want = np.asarray(jlosses.laplacian_pyramid(jnp.asarray(masks)))
    got = laplacian_pyramid(torch.from_numpy(masks))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == shape + (3,) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # class ids alone give at most 8 * 18: the 255s were convolved too
    assert np.abs(want).max() > 8 * 18
