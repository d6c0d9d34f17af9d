"""PyTorch port against the JAX package: ESPNet (logits at full size)
and ESPNetv2 (1/8), at their registry defaults on a small input, with the
checks of tests/test_torch_resnet_models.py (parameter paths, eval logits
within 1e-4 deferred and not, a training forward held to the Flax model
run in float64) and the bf16 logits' type
(tests/test_torch_gated_models.py); and, for all ten models that need no
new op, their registry entries and their refusal of `backbone_ckpt`.
ESPNet's and DFANet's other variants are in
tests/test_torch_model_variants.py.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import PORTED, get_model
from rtseg_tpu_torch.train import SegTrainer
from test_torch_gated_models import FAMILY, check_bf16_logits
from test_torch_resnet_models import (H, NC, W, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward, flax_model)

VARIANTS = ('espnet', 'espnetv2')


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
    check_bf16_logits(variant)


def test_espnet_decoder_takes_the_split_branch():
    """The decoder's ESP modules (19 channels, K = 5) take the branch
    whose first dilation gets the remainder: 7 channels through `conv_k1`
    beside 3 a branch through `conv_kn`; the encoder's 64- and 128-wide
    modules split as 16 + 4 x 12 and 28 + 4 x 25."""
    model = get_model(SegConfig(model='espnet', num_class=NC,
                                use_aux=False))
    esp = model.Decoder_0.ESPModule_0
    assert esp.split and not hasattr(esp, 'Conv_0')
    assert esp.conv_k1.conv.out_channels == 7
    assert esp.conv_kn.conv.out_channels == 3
    assert (model.ESPModule_0.conv_k1.conv.out_channels,
            model.ESPModule_0.conv_kn.conv.out_channels) == (16, 12)
    assert (model.ESPModule_4.conv_k1.conv.out_channels,
            model.ESPModule_4.conv_kn.conv.out_channels) == (28, 25)


def test_registry_builds_the_ten_and_refuses_heads():
    """The ten names build their models at the JAX registry's defaults;
    aux and detail heads raise ValueError for each, as in the JAX
    registry."""
    from rtseg_tpu.models.registry import model_class
    assert len(PORTED) == 36 and set(FAMILY) <= set(PORTED)
    for name in FAMILY:
        model = get_model(SegConfig(model=name, num_class=NC, use_aux=False))
        assert type(model).__name__ == model_class(name).__name__
        with pytest.raises(ValueError, match='auxiliary heads'):
            get_model(SegConfig(model=name, num_class=NC, use_aux=True))
        with pytest.raises(ValueError, match='detail heads'):
            get_model(SegConfig(model=name, num_class=NC, use_aux=False,
                                use_detail_head=True))


@pytest.mark.parametrize('variant', FAMILY)
def test_backbone_ckpt_is_refused(variant, tmp_path):
    """None of the ten has a top-level backbone scope (DFANet's encoders
    are `backbone1..3`); the JAX trainer looks there only, so both
    packages refuse `backbone_ckpt`."""
    from test_torch_init_and_import import _cfg, _torchvision_file
    tree = jax.eval_shape(lambda: flax_model(variant).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))['params']
    assert not {'backbone', 'frontend', 'encoder'} & set(tree)
    path = _torchvision_file(tmp_path, 'resnet18')
    with pytest.raises(ValueError, match='no backbone scope'):
        SegTrainer(_cfg(tmp_path, model=variant, backbone_ckpt=path),
                   device='cpu')
