"""PyTorch port against the JAX package: one float32 train step of
ERFNet and FSSNet at their registry defaults, and of CFPNet and
MiniNetv2 with their depth cut, from the same variables on the same batch
as the JAX build_train_step (the loss within 1e-5 relative, params,
batch_stats and their EMA within 1e-4, at a peak LR of 1e-3;
tests/test_torch_resnet_train.py); and the validation of MiniNetv2, whose
logits come at 1/2 resolution through the fused head, and of ERFNet,
whose logits come at full size, against the JAX eval step.

The cut depths: CFPNet's default eight CFP modules take the JAX train
step about 80 s to compile here, so it runs with one module a stage (its
full depth is held by the forward checks of
tests/test_torch_stem_models.py). MiniNetv2's gradient at random weights
is dominated by float32 rounding at its full depth: through its 30
depth-wise blocks the JAX package's own float32 and float64 gradients
disagree, and two float32 CPU runs of the port from weights 1e-7 apart
part its weights by 1.09 after 3 steps (zoo_check_spread.py), so no two
float32 implementations can agree to 1e-4 there. With `feat_dt` cut to
two blocks at 1/8 (16 blocks in all) one step is held as the others.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from rtseg_tpu_torch.models.cfpnet import CFPNet
from rtseg_tpu_torch.models.mininetv2 import MiniNetv2
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.train import trainer as trainer_mod
from rtseg_tpu_torch.utils.convert import (random_jax_variables,
                                           to_jax_variables)
from test_torch_resnet_train import (KW, NC, _mesh, assert_trees_close,
                                     batches, check_steps, check_validation,
                                     jax_config, jax_state, port_config)

# variant -> (port class, JAX class path, constructor switches)
CUT = {
    'cfpnet': (CFPNet, 'rtseg_tpu.models.cfpnet.CFPNet',
               dict(n=1, m=1, dilations=(2, 4))),
    'mininetv2': (MiniNetv2, 'rtseg_tpu.models.mininetv2.MiniNetv2',
                  dict(feat_dt=(1, 2))),
}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant', ['erfnet', 'fssnet'])
def test_one_train_step_matches_jax(variant, tmp_path):
    check_steps(variant, 1, tmp_path)


def _flax_cut(variant):
    import importlib
    path, name = CUT[variant][1].rsplit('.', 1)
    return getattr(importlib.import_module(path), name)(
        num_class=NC, **CUT[variant][2])


@pytest.mark.parametrize('variant', sorted(CUT))
def test_one_train_step_at_cut_depth_matches_jax(variant, tmp_path,
                                                 monkeypatch):
    """The trainer builds the cut model (its get_model patched), the JAX
    step the Flax model of the same depth; the checks of check_steps."""
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.step import build_train_step as jax_train_step
    cls, _, switches = CUT[variant]
    v = random_jax_variables(cls(num_class=NC, **switches), seed=17)
    jcfg = jax_config(variant)
    jcfg.resolve_schedule(train_num=KW['synthetic_len'])
    opt = get_optimizer(jcfg)
    step = jax_train_step(jcfg, _flax_cut(variant), opt, _mesh())
    state = jax_state(v, opt)
    imgs, msks = batches(variant, 1)[0]
    state, m = step(state, jnp.asarray(imgs), jnp.asarray(msks))
    want = jax.device_get(
        {'variables': {'params': state.params,
                       'batch_stats': state.batch_stats},
         'ema': {'params': state.ema_params,
                 'batch_stats': state.ema_batch_stats}})

    monkeypatch.setattr(trainer_mod, 'get_model',
                        lambda cfg, device=None: cls(
                            num_class=NC, device=device, **switches))
    trainer = SegTrainer(port_config(variant, tmp_path), device='cpu',
                         variables=v)
    trainer.state, got = trainer.train_step(
        trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
    assert float(got['loss']) == pytest.approx(float(m['loss']), rel=1e-5)
    assert_trees_close(to_jax_variables(trainer.model), want['variables'],
                       1e-4, 'params/batch_stats')
    assert_trees_close(to_jax_variables(trainer.ema_model), want['ema'],
                       1e-4, 'ema')


@pytest.mark.parametrize('variant', ['mininetv2', 'erfnet'])
def test_validation_equals_the_jax_eval_step(variant, tmp_path):
    """MiniNetv2's 1/2-resolution logits through the fused head, ERFNet's
    full-size ones through the identity-size argmax: confusion matrices
    equal to the JAX eval step's (fused head and Pallas confusion matrix,
    interpret mode)."""
    check_validation(variant, tmp_path)
