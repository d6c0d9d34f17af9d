"""PyTorch port against the JAX package: ERFNet, ESNet, FDDWNet and
FSSNet, whose logits come at full size through transposed convs, at their
registry defaults on a small input, with the checks of
tests/test_torch_resnet_models.py: parameter paths equal to the Flax init
tree's, eval logits within 1e-4 (the deferred forward is the full-size
one), and a training forward's outputs and batch_stats against the Flax
model run in float64.
"""

import pytest
import torch

from test_torch_resnet_models import (check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward)

VARIANTS = ('erfnet', 'esnet', 'fddwnet', 'fssnet')


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
