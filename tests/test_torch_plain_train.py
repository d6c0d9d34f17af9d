"""PyTorch port against the JAX package: three float32 train steps of
SQNet, EDANet and ADSCNet at their registry defaults from the same
variables on the same batches as the JAX build_train_step, with the checks
of tests/test_torch_resnet_train.py: each step's loss within 1e-5
relative, params, batch_stats and their EMA within 1e-4, at a peak LR of
1e-3. ContextNet and FPENet are in tests/test_torch_plain_train_steps.py,
ESPNet and ESPNetv2 in tests/test_torch_esp_train.py, CGNet, RegSeg and
DFANet in tests/test_torch_gated_train.py.
"""

import pytest
import torch

from test_torch_resnet_train import check_steps


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant', ['sqnet', 'edanet', 'adscnet'])
def test_three_train_steps_match_jax(variant, tmp_path):
    check_steps(variant, 3, tmp_path)
