"""PyTorch port against the JAX package: the three models of the
family with Flax `Dense` layers, CGNet (logits at 1/8), RegSeg and DFANet
(1/4), at their registry defaults on a small input, with the checks of
tests/test_torch_resnet_models.py (parameter paths, eval logits within
1e-4 deferred and not, a training forward held to the Flax model run in
float64; DFANet's in float64 at full depth and in float32 at a cut
depth, as its tests say why), the float32 type of their bf16 logits,
and the Flax initializers' fan-in for CGNet's Dense gate. DFANet's other
variants are in tests/test_torch_model_variants.py. The other seven
models that need no new op are in tests/test_torch_plain_models.py and
tests/test_torch_esp_models.py.

Their Dense layers (CGNet's `glo1` and `glo2`, the auto-named `Dense_n`
of RegSeg's SE gates and DFANet's FC attention) are mapped by the
converter by their module type alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.utils.convert import (_flatten, flax_init_variables,
                                           load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)
from test_torch_backbone import assert_near_float64, flax_train_forward
from test_torch_resnet_models import (H, NC, W, _input, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward, flax_model,
                                      port_model, variables)

VARIANTS = ('cgnet', 'regseg', 'dfanet')
# the ten models that need no new op
FAMILY = ('sqnet', 'edanet', 'adscnet', 'contextnet', 'fpenet', 'espnet',
          'espnetv2') + VARIANTS


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant', VARIANTS)
def test_parameter_paths_equal_the_flax_init_tree(variant):
    check_parameter_paths(variant)


@pytest.mark.parametrize('defer', [False, True])
@pytest.mark.parametrize('variant', VARIANTS)
def test_eval_logits_match_flax(variant, defer):
    check_eval_logits(variant, defer)


@pytest.mark.parametrize('variant', VARIANTS[:-1])
def test_training_forward_and_batch_stats_match_flax(variant):
    check_training_forward(variant)


def test_dfanet_training_forward_matches_flax_in_float64():
    """At its full depth DFANet's float32 training forward at random
    weights is chaotic: through three cascaded encoders of 14 blocks and
    FC attentions whose BatchNorm sees the batch's 4 values a channel,
    Flax's own float32 logits part from its float64 ones by 0.94
    (relative), the port's by 0.89, so no float32 run can be held to
    another there. The port runs it in float64 instead (`model.double()`:
    its train BatchNorm and Dense layers compute in their input's type)
    against the Flax float64 run: logits and batch_stats within 1e-6."""
    x = _input(seed=7, n=4)
    _, (out64, bs64) = flax_train_forward(flax_model('dfanet'),
                                          variables('dfanet'), x)
    model = port_model('dfanet').double().train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).double())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), out64, rtol=1e-6, atol=1e-6)
    got_bs = dict(_flatten(to_jax_variables(model)['batch_stats']))
    bs64 = dict(_flatten(bs64))
    assert got_bs.keys() == bs64.keys()
    for k in bs64:
        np.testing.assert_allclose(got_bs[k], bs64[k], rtol=1e-6, atol=1e-6,
                                   err_msg='/'.join(k))


def test_dfanet_training_forward_at_cut_depth_matches_flax():
    """With one block a stage (`repeat_times=(1, 1, 1)`) DFANet's float32
    training forward is well conditioned (Flax's float32 logits within
    4.3e-3 of its float64 ones, the port's within 9.4e-4; batch_stats
    5.5e-5 and 7.6e-6): held in float32 to the Flax model run in float64
    as the other models are (`assert_near_float64`)."""
    from rtseg_tpu.models.dfanet import DFANet as FlaxDFANet
    from rtseg_tpu_torch.models import DFANet
    cut = dict(repeat_times=(1, 1, 1))
    model = DFANet(NC, **cut)
    v = random_jax_variables(model, seed=5)
    load_jax_variables(model, v)
    x = _input(seed=7, n=4)
    (out32, bs32), (out64, bs64) = flax_train_forward(
        FlaxDFANet(num_class=NC, **cut), v, x)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))
    assert_near_float64(got.numpy(), out64, out32, 'logits')
    got_bs = dict(_flatten(to_jax_variables(model)['batch_stats']))
    bs32, bs64 = dict(_flatten(bs32)), dict(_flatten(bs64))
    assert got_bs.keys() == bs64.keys()
    for k in bs64:
        assert_near_float64(got_bs[k], bs64[k], bs32[k], '/'.join(k))


def check_bf16_logits(variant):
    """Flax's Dense promotes its bf16 input to its float32 parameters, so
    CGNet from its first gated block on, RegSeg from its first SE gate on
    and DFANet from backbone1's FC attention on run in float32 in the JAX
    model, which returns float32 logits on bf16 input; the other seven
    models of the family return bf16. The port returns the same types, and
    its bf16 eval logits stay near its float32 ones."""
    fmodel = flax_model(variant)
    want = jax.eval_shape(lambda: fmodel.init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.bfloat16),
        False)[0]).dtype
    assert (want == jnp.float32) == (variant in VARIANTS)
    model = port_model(variant).eval()
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1.5, 1.5, (2, H, W, 3)).astype(np.float32))
    with torch.inference_mode():
        low = model(x.to(torch.bfloat16))
        ref = model(x)
    assert str(low.dtype) == f'torch.{want}'
    assert tuple(low.shape) == (2, H, W, NC)
    assert float((low.float() - ref).abs().max()) < \
        0.05 * float(ref.abs().max())


@pytest.mark.parametrize('variant', VARIANTS)
def test_bf16_logits_take_the_flax_models_type(variant):
    check_bf16_logits(variant)


def test_flax_init_gives_cgnet_dense_kernels_their_fan_in():
    """flax_init_variables draws a Dense kernel (in, out) with variance
    1 / in, as Flax's lecun-normal does: CGNet's `glo1` and `glo2` kernels
    against the Flax twin's `model.init` (the same tree and constants,
    std * sqrt(in) within sampling error of 1 for each kernel and pooled)."""
    from test_torch_init_and_import import _kernel_checks
    kw = dict(model='cgnet', num_class=NC, use_aux=False)
    got = dict(_flatten(flax_init_variables(get_model(SegConfig(**kw)),
                                            seed=0)))
    want = dict(_flatten(jax.device_get(flax_model('cgnet').init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for k, v in got.items():
        if k[-1] != 'kernel':
            np.testing.assert_array_equal(v, want[k], err_msg='/'.join(k))
    for what, flat in (('port', got), ('flax', want)):
        dense = {k: v for k, v in flat.items()
                 if k[-2] in ('glo1', 'glo2')}
        assert len(dense) == 2 * 18 * 2                # kernels and biases
        pooled = _kernel_checks(dense, what)
        assert abs(pooled - 1) < 0.05, (what, pooled)
