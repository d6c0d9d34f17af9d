"""PyTorch port against the JAX package: LinkNet (ResNet-18, ending in
transposed convs at full resolution), LiteSeg and CANet (MobileNetV2;
CANet ends in an 8x transposed conv), at full width on a small input, with
the checks of tests/test_torch_resnet_models.py: parameter paths equal to
the Flax init tree's, eval logits within 1e-4 deferred and not, and a
training forward's outputs and batch_stats against the Flax model run in
float64.
"""

import numpy as np
import pytest
import torch

from test_torch_resnet_models import (H, NC, W, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward, port_model)

VARIANTS = ('linknet', 'liteseg', 'canet')


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


@pytest.mark.parametrize('variant', VARIANTS)
def test_training_forward_and_batch_stats_match_flax(variant):
    check_training_forward(variant)


@pytest.mark.parametrize('variant', VARIANTS)
def test_bf16_logits_take_the_flax_models_type(variant):
    """Flax's Dense promotes its bf16 input to its float32 parameters, so
    CANet's channel gate and everything after the gating product run in
    float32 in the JAX model, which returns float32 logits on bf16 input;
    LinkNet and LiteSeg return bf16. The port returns the same types, and
    its bf16 eval logits stay near its float32 ones."""
    import jax
    import jax.numpy as jnp
    from test_torch_resnet_models import flax_model
    fmodel = flax_model(variant)
    want = jax.eval_shape(lambda: fmodel.init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.bfloat16),
        False)[0]).dtype
    assert (want == jnp.float32) == (variant == 'canet')
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
