"""PyTorch port against the JAX package: five of the ten models that need
no new op, SQNet and ADSCNet (logits at full size), EDANet (1/8),
ContextNet and FPENet (1/2), at their registry defaults on a small input,
with the checks of tests/test_torch_resnet_models.py: parameter paths
equal to the Flax init tree's, eval logits within 1e-4 deferred and not,
and a training forward's outputs and batch_stats against the Flax model
run in float64, and the bf16 logits' type
(tests/test_torch_gated_models.py). ESPNet and ESPNetv2 are in
tests/test_torch_esp_models.py, CGNet, RegSeg and DFANet in
tests/test_torch_gated_models.py.
"""

import pytest
import torch

from test_torch_gated_models import check_bf16_logits
from test_torch_resnet_models import (check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward)

VARIANTS = ('sqnet', 'edanet', 'adscnet', 'contextnet', 'fpenet')


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
    """FPENet's channel gate (`MEUModule.ca`) normalizes over a 1x1 map:
    in training its BatchNorm sees the batch's 4 values a channel."""
    check_training_forward(variant)


@pytest.mark.parametrize('variant', VARIANTS)
def test_bf16_logits_take_the_flax_models_type(variant):
    check_bf16_logits(variant)


def test_edanet_and_regseg_keep_their_fixed_depths():
    """EDANet's module counts and RegSeg's 13 dilation pairs are fixed, as
    in the JAX models: RegSeg raises for another count."""
    from rtseg_tpu_torch.models import EDANet, RegSeg
    model = EDANet(19)
    assert sum(name.startswith('EDAModule_')
               for name, _ in model.named_children()) == 13
    with pytest.raises(ValueError, match='13'):
        RegSeg(19, dilations=((1, 1),) * 12)
