"""PyTorch port against the JAX package: PP-LiteSeg (its own STDC1 encoder,
SPPM and the UAFM decoder) at its registry defaults on a small input.

The checks of tests/test_torch_resnet_models.py (parameter paths equal to
the Flax init tree's, eval logits within 1e-4 deferred and not, a training
forward's outputs and batch_stats against the Flax model run in float64)
for the spatial fusion the registry builds and for the channel fusion;
UAFM's input gradients where the channel maxima tie, against JAX's (which
splits a max's gradient evenly among equal maxima); one float32 train step
against the JAX build_train_step (tests/test_torch_resnet_train.py: the
loss within 1e-5 relative, params, batch_stats and EMA within 1e-4, at a
peak LR of 1e-3); and its validation, 1/8-resolution logits through the
fused head, against the JAX eval step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.models.pp_liteseg import PPLiteSeg, UAFM
from rtseg_tpu_torch.utils.convert import (_flatten, load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)
from test_torch_backbone import (_flax_tree, assert_near_float64,
                                 flax_train_forward)
from test_torch_resnet_models import (H, NC, W, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward)
from test_torch_resnet_train import check_steps, check_validation


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parameter_paths_equal_the_flax_init_tree():
    check_parameter_paths('ppliteseg')


@pytest.mark.parametrize('defer', [False, True])
def test_eval_logits_match_flax(defer):
    check_eval_logits('ppliteseg', defer)


def test_training_forward_and_batch_stats_match_flax():
    check_training_forward('ppliteseg')


def test_channel_fusion_matches_flax():
    """fusion_type='channel' (gates from global means and maxima), built
    directly: parameter tree, eval logits within 1e-4 and a training
    forward against the Flax model run in float64."""
    from rtseg_tpu.models.pp_liteseg import PPLiteSeg as FlaxPPLiteSeg
    fmodel = FlaxPPLiteSeg(num_class=NC, fusion_type='channel')
    model = PPLiteSeg(num_class=NC, fusion_type='channel')
    x = np.random.RandomState(5).uniform(-1.5, 1.5, (2, H, W, 3)).astype(
        np.float32)
    got = {k: tuple(v.shape)
           for k, v in _flatten(to_jax_variables(model)).items()}
    assert got == _flax_tree(fmodel, x)
    v = random_jax_variables(model, seed=21)
    load_jax_variables(model, v)
    want = np.asarray(jax.jit(lambda v, x: fmodel.apply(v, x, False))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4)
    (out32, bs32), (out64, bs64) = flax_train_forward(fmodel, v, x)
    with torch.no_grad():
        out = model.train()(torch.from_numpy(x)).numpy()
    assert_near_float64(out, out64, out32, 'logits')
    got_bs = dict(_flatten(to_jax_variables(model)['batch_stats']))
    bs32, bs64 = dict(_flatten(bs32)), dict(_flatten(bs64))
    assert got_bs.keys() == bs64.keys()
    for k in bs64:
        assert_near_float64(got_bs[k], bs64[k], bs32[k], '/'.join(k))


@pytest.mark.parametrize('fusion', ['spatial', 'channel'])
def test_uafm_gradients_split_at_tied_maxima_as_jax(fusion):
    """Inputs whose channel maxima tie (integer values in a few levels):
    the gradients of both inputs equal JAX's within 1e-5, which needs the
    max's gradient split evenly among the tied channels."""
    from rtseg_tpu.models.pp_liteseg import UAFM as FlaxUAFM
    rs = np.random.RandomState(3)
    x_high = rs.randint(-2, 3, (2, 4, 6, 8)).astype(np.float32)
    x_low = rs.randint(-2, 3, (2, 8, 12, 16)).astype(np.float32)
    r = rs.uniform(-1, 1, (2, 8, 12, 8)).astype(np.float32)
    fmodule = FlaxUAFM(8, fusion)
    module = UAFM(8, 16, 8, fusion)
    v = random_jax_variables(module, seed=4)
    load_jax_variables(module, v)
    assert float((x_high.max(-1, keepdims=True) == x_high).sum(-1).max()) > 1

    def f(xh, xl):
        return (fmodule.apply(v, xh, xl, False) * r).sum()

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x_high),
                                       jnp.asarray(x_low))
    xh = torch.from_numpy(x_high).permute(0, 3, 1, 2).requires_grad_()
    xl = torch.from_numpy(x_low).permute(0, 3, 1, 2).requires_grad_()
    out = module(xh, xl).permute(0, 2, 3, 1)
    (out * torch.from_numpy(r)).sum().backward()
    for g, w in zip((xh.grad, xl.grad), want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=1e-5, rtol=1e-5)


def test_one_train_step_matches_jax(tmp_path):
    check_steps('ppliteseg', 1, tmp_path)


def test_validation_equals_the_jax_eval_step(tmp_path):
    check_validation('ppliteseg', tmp_path)
