"""PyTorch port against the JAX package: the constructor variants of
ESPNet and DFANet that their registry defaults do not build (ESPNet's
-a, -b and -c architectures; DFANet with backbone1 alone and with the
Xception-B encoders), at a small input: parameter tree equal to the Flax
init tree's, eval logits within 1e-4 of the Flax model's, deferred and
not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resnet_models import H, NC, W, _input


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_variant_eval(port_cls, flax_cls, kw, stride):
    """A model built with constructor switches other than the registry's:
    parameter tree equal to the Flax init tree's, eval logits within 1e-4
    of the Flax model's, deferred (at 1/`stride`) and not."""
    from rtseg_tpu.ops import set_defer_final_upsample
    from rtseg_tpu_torch.utils.convert import (_flatten, load_jax_variables,
                                               random_jax_variables,
                                               to_jax_variables)
    model = port_cls(NC, **kw).eval()
    fmodel = flax_cls(num_class=NC, **kw)
    x = _input()
    tree = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))
    assert {k: tuple(v.shape) for k, v in _flatten(to_jax_variables(
        model)).items()} == {k: tuple(v.shape) for k, v in _flatten(
            jax.tree.map(lambda s: np.zeros(s.shape), tree)).items()}
    v = random_jax_variables(model, seed=6)
    load_jax_variables(model, v)
    for defer in (False, True):
        try:
            set_defer_final_upsample(defer)
            want = np.asarray(fmodel.apply(jax.tree.map(jnp.asarray, v),
                                           jnp.asarray(x), False))
        finally:
            set_defer_final_upsample(False)
        with torch.inference_mode():
            got = model(torch.from_numpy(x), defer_upsample=defer).numpy()
        s = stride if defer else 1
        assert got.shape == (2, H // s, W // s, NC)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('arch,stride', [('espnet-a', 8), ('espnet-b', 8),
                                         ('espnet-c', 8)])
def test_espnet_variants_match_flax(arch, stride):
    """ESPNet's -a (no skips, the 1/4 width at 1/8), -b (skips) and -c
    (skips and input reinforcement) variants: a 1x1 conv at 1/8 and the
    final upsample in place of the decoder."""
    from rtseg_tpu.models.espnet import ESPNet as FlaxESPNet
    from rtseg_tpu_torch.models import ESPNet
    check_variant_eval(ESPNet, FlaxESPNet, dict(arch_type=arch), stride)
    with pytest.raises(ValueError, match='Unsupport architecture'):
        ESPNet(NC, arch_type='espnet-d')


@pytest.mark.parametrize('kw,stride', [
    (dict(use_extra_backbone=False), 16),
    (dict(backbone_type='XceptionB'), 4),
], ids=['one_backbone', 'xception_b'])
def test_dfanet_variants_match_flax(kw, stride):
    """DFANet with backbone1 alone (a segmentation head at 1/16) and with
    the narrower Xception-B encoders."""
    from rtseg_tpu.models.dfanet import DFANet as FlaxDFANet
    from rtseg_tpu_torch.models import DFANet
    check_variant_eval(DFANet, FlaxDFANet, kw, stride)
    with pytest.raises(NotImplementedError):
        DFANet(NC, backbone_type='XceptionC')
