"""PyTorch port against the JAX package: ENet's InitialBlock alone, and the
models built on it whose logits come at low resolution, CFPNet and DABNet
(1/8) and MiniNetv2 (1/2), at their registry defaults on a small input,
with the checks of tests/test_torch_resnet_models.py: parameter paths
equal to the Flax init tree's, eval logits within 1e-4 deferred and not,
and a training forward's outputs and batch_stats against the Flax model
run in float64. ERFNet, ESNet, FDDWNet and FSSNet, whose logits come at
full size, are in tests/test_torch_stem_fullres_models.py. The registry's
dispatch and refusals for the eight models of this slice close the file.
"""

import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import PORTED, get_model
from rtseg_tpu_torch.models.enet import InitialBlock
from test_torch_backbone import _check_against_flax
from test_torch_resnet_models import (NC, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward)

VARIANTS = ('cfpnet', 'dabnet', 'mininetv2')
NEW = ('ppliteseg', 'cfpnet', 'dabnet', 'erfnet', 'esnet', 'fddwnet',
       'fssnet', 'mininetv2')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('act,cin,cout,shape', [
    ('prelu', 3, 16, (2, 32, 48)),
    ('relu', 16, 64, (2, 16, 24)),
    ('prelu', 35, 64, (2, 15, 23)),        # odd sizes: ceil(n / 2) rows
])
def test_initial_block_matches_flax(act, cin, cout, shape):
    """The strided ConvBNAct to cout - cin channels beside max_pool(3,2,1),
    concatenated: parameter tree, eval output, training output and
    batch_stats against the Flax block."""
    from rtseg_tpu.models.enet import InitialBlock as FlaxInitialBlock
    x = np.random.RandomState(cin).uniform(
        -1.5, 1.5, shape + (cin,)).astype(np.float32)
    _check_against_flax(InitialBlock(cin, cout, act),
                        FlaxInitialBlock(cout, act), x, seed=cin)


def test_initial_block_needs_more_channels_out_than_in():
    with pytest.raises(ValueError, match='larger'):
        InitialBlock(16, 16)


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


def test_registry_dispatch_and_refusals_of_the_new_models():
    """The eight names build their models at the JAX registry's defaults;
    aux and detail heads raise ValueError for each, as in the JAX registry;
    PP-LiteSeg refuses the TPU lever hires_remat."""
    from rtseg_tpu.models.registry import model_class
    assert len(PORTED) == 36 and set(NEW) <= set(PORTED)
    for name in NEW:
        model = get_model(SegConfig(model=name, num_class=NC, use_aux=False))
        assert type(model).__name__ == model_class(name).__name__
        for kw in (dict(use_aux=True), dict(use_detail_head=True)):
            with pytest.raises(ValueError, match='support'):
                get_model(SegConfig(model=name, num_class=NC,
                                    **{'use_aux': False, **kw}))
    with pytest.raises(NotImplementedError, match='hires_remat'):
        get_model(SegConfig(model='ppliteseg', num_class=NC, use_aux=False,
                            hires_remat=True))
