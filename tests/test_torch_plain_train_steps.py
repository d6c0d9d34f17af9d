"""PyTorch port against the JAX package: one float32 train step of
ContextNet and FPENet at their registry defaults from the same variables
on the same batch as the JAX build_train_step (the loss within 1e-5
relative, params, batch_stats and their EMA within 1e-4, at a peak LR of
1e-3; tests/test_torch_resnet_train.py), and the validation of
ContextNet, whose logits come at 1/2 resolution through the fused head,
against the JAX eval step.

One step, not three: by the third step float32 rounding alone parts two
CPU runs of the port from weights 1e-7 apart as far as the port parts
from the JAX step (ContextNet's weights by 1.47e-4 beyond the 1e-4
tolerance, FPENet's third loss by 1.57e-4 relative).
"""

import pytest
import torch

from test_torch_resnet_train import check_steps, check_validation


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant', ['contextnet', 'fpenet'])
def test_one_train_step_matches_jax(variant, tmp_path):
    check_steps(variant, 1, tmp_path)


def test_contextnet_validation_equals_the_jax_eval_step(tmp_path):
    check_validation('contextnet', tmp_path)
