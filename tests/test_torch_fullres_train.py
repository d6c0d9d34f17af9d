"""PyTorch port against the JAX package: one float32 train step of
LinkNet, LiteSeg and CANet from the same variables on the same batch as the
JAX build_train_step (the loss within 1e-5 relative, params, batch_stats
and their EMA within 1e-4; tests/test_torch_resnet_train.py), and the
validation of LinkNet and CANet, whose logits come at full resolution, so
that the eval step takes the identity-size argmax, as the JAX eval step
does.
"""

import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train import build_eval_step
from test_torch_resnet_train import (H, NC, W, check_steps,
                                     check_validation, variables)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant', ['linknet', 'liteseg', 'canet'])
def test_one_train_step_matches_jax(variant, tmp_path):
    check_steps(variant, 1, tmp_path)


@pytest.mark.parametrize('variant', ['linknet', 'canet'])
def test_full_resolution_validation_equals_the_jax_eval_step(variant,
                                                             tmp_path):
    check_validation(variant, tmp_path)


@pytest.mark.parametrize('variant', ['linknet', 'canet'])
def test_eval_step_takes_the_identity_shortcut(variant, monkeypatch):
    """With the fused head on, the eval step hands the full-resolution
    logits to resize_argmax, which takes the plain argmax at equal sizes
    and never reaches the plain upsample (nor, on the card, the kernel)."""
    from rtseg_tpu_torch.ops import fused_head
    from rtseg_tpu_torch.utils.convert import load_jax_variables

    def refuse(*args, **kwargs):
        raise AssertionError('the upsample path was taken')

    monkeypatch.setattr(fused_head, '_argmax_ref', refuse)
    cfg = SegConfig(model=variant, num_class=NC, use_aux=False,
                    fused_head=True, use_pallas_metrics=False,
                    compute_dtype='float32')
    model = get_model(cfg).eval()
    load_jax_variables(model, variables(variant))
    step = build_eval_step(cfg, model, 'cpu')
    assert step.fused
    imgs = torch.rand(2, H, W, 3)
    masks = torch.randint(0, NC, (2, H, W))
    with torch.inference_mode():
        want = torch.argmax(model(imgs), dim=-1)
    cm = step(imgs, masks)
    assert int(cm.sum()) == 2 * H * W
    # the confusion matrix of the plain argmax
    keys = masks.reshape(-1) * NC + want.reshape(-1)
    assert torch.equal(cm.long(), torch.bincount(
        keys, minlength=NC * NC).reshape(NC, NC))
