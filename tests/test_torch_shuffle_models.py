"""PyTorch port against the JAX package: the models built on the channel
shuffle, LEDNet (logits at 1/8) and AGLNet (at 1/2), at their registry
defaults on a small input, with the checks of
tests/test_torch_resnet_models.py: parameter paths equal to the Flax init
tree's, eval logits within 1e-4 deferred and not, a training forward's
outputs and batch_stats against the Flax model run in float64, and the
bf16 logits' type (tests/test_torch_gated_models.py); LEDNet's SSnbt unit
alone. Lite-HRNet is in tests/test_torch_litehrnet.py. The registry's
dispatch for the six models of this slice, all 36 names of the JAX
registry, and SegNet's refusal of the TPU's packed layout close the file.
"""

import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import PORTED, get_model
from rtseg_tpu_torch.models.lednet import SSnbtUnit
from test_torch_backbone import _check_against_flax
from test_torch_gated_models import check_bf16_logits
from test_torch_resnet_models import (NC, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward)

VARIANTS = ('lednet', 'aglnet')
NEW = ('lednet', 'aglnet', 'lite_hrnet', 'enet', 'mininet', 'segnet')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('dilation,c', [(1, 32), (5, 16)])
def test_ssnbt_unit_matches_flax(dilation, c):
    """The split, the twin asymmetric branches (biased bare convs and
    ConvBNActs, dilated in their second pair), the residual and the
    shuffle: parameter tree, eval output, training output and batch_stats
    against the Flax unit."""
    from rtseg_tpu.models.lednet import SSnbtUnit as FlaxSSnbtUnit
    x = np.random.RandomState(c).uniform(
        -1.5, 1.5, (2, 12, 16, c)).astype(np.float32)
    _check_against_flax(SSnbtUnit(c, dilation), FlaxSSnbtUnit(dilation), x,
                        seed=dilation)


def test_ssnbt_unit_needs_even_channels():
    with pytest.raises(ValueError, match='multiple of 2'):
        SSnbtUnit(15)


@pytest.mark.parametrize('variant', VARIANTS)
def test_parameter_paths_equal_the_flax_init_tree(variant):
    check_parameter_paths(variant)


@pytest.mark.parametrize('defer', [False, True])
@pytest.mark.parametrize('variant', VARIANTS)
def test_eval_logits_match_flax(variant, defer):
    check_eval_logits(variant, defer)


@pytest.mark.parametrize('variant', VARIANTS)
def test_training_forward_and_batch_stats_match_flax(variant):
    """LEDNet's attention-pyramid head normalizes a 3x3 conv of the global
    average: in training its BatchNorm sees the batch's 4 values a
    channel."""
    check_training_forward(variant)


@pytest.mark.parametrize('variant', VARIANTS)
def test_bf16_logits_take_the_flax_models_type(variant):
    check_bf16_logits(variant)


def test_registry_builds_all_36_names_and_the_six_new_models():
    """Every name of the JAX registry is ported; the six of this slice
    build at the JAX registry's defaults (Lite-HRNet at litehrnet18) and
    refuse aux and detail heads with its ValueErrors; SegNet refuses the
    TPU's packed layout (config.segnet_pack), and the smp hub waits for
    its ROADMAP item."""
    from rtseg_tpu.models.registry import MODEL_NAMES, model_class
    assert sorted(PORTED) == sorted(MODEL_NAMES) and len(PORTED) == 36
    for name in NEW:
        model = get_model(SegConfig(model=name, num_class=NC, use_aux=False))
        assert type(model).__name__ == model_class(name).__name__
        for kw in (dict(use_aux=True), dict(use_detail_head=True)):
            with pytest.raises(ValueError, match='support'):
                get_model(SegConfig(model=name, num_class=NC,
                                    **{'use_aux': False, **kw}))
    hr = get_model(SegConfig(model='lite_hrnet', num_class=NC,
                             use_aux=False))
    assert [hr.StageBlock_0.num_modules, hr.StageBlock_1.num_modules,
            hr.StageBlock_2.num_modules] == [2, 4, 2]
    with pytest.raises(ValueError, match='packed'):
        get_model(SegConfig(model='segnet', num_class=NC, use_aux=False,
                            segnet_pack=True))
    # the smp hub is ported (tests/test_torch_smp_models.py): without a
    # decoder it raises the JAX package's ValueError
    with pytest.raises(ValueError, match='Unsupported decoder type'):
        get_model(SegConfig(model='smp', num_class=NC, use_aux=False))
