"""PyTorch port against the JAX package: one float32 train step of DABNet,
ESNet and FDDWNet from the same variables on the same batch as the JAX
build_train_step, with the checks of tests/test_torch_resnet_train.py:
the loss within 1e-5 relative, params, batch_stats and their EMA within
1e-4, at a peak LR of 1e-3. ERFNet, FSSNet, CFPNet and MiniNetv2 are in
tests/test_torch_stem_train_steps.py.
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


@pytest.mark.parametrize('variant', ['dabnet', 'esnet', 'fddwnet'])
def test_one_train_step_matches_jax(variant, tmp_path):
    check_steps(variant, 1, tmp_path)
