"""PyTorch port against the JAX package: float32 train steps of LEDNet and
AGLNet (the shuffle models) from the same variables on the same batches as
the JAX build_train_step (each step's loss within 1e-5 relative, params,
batch_stats and their EMA within 1e-4, at a peak LR of 1e-3;
tests/test_torch_resnet_train.py), and LEDNet's validation, whose logits
come at 1/8 through the fused head, against the JAX eval step. The other
four models are in tests/test_torch_last_train_steps.py, with the helper
here that gives both packages the same dropout masks.

Both run one step. By the third, float32 rounding alone parts two CPU runs
of the port from weights 1e-7 apart (zoo_check_spread.py) by 6.7e-4 to
8.8e-4 in LEDNet's weights and 2.7e-3 to 3.9e-3 in AGLNet's (GAUM_1's
BatchNorm), beyond the 1e-4 tolerance; the port parts from the JAX step
after one step by 2.4e-6 (LEDNet) and 2.5e-6 (AGLNet). LEDNet's step takes
16 samples: its attention head normalizes a conv of the global average,
one value a sample and channel, and at 4 samples the same two CPU runs
part its first-step loss by 3.4e-6 to 1.5e-5, at 16 by 2.4e-6 to 4.6e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.train import SegTrainer, build_train_step
from rtseg_tpu_torch.utils.convert import (random_jax_variables,
                                           to_jax_variables)
from test_torch_resnet_train import (KW, _mesh, assert_trees_close,
                                     check_validation, jax_config,
                                     jax_state, port_config, variables)
from test_torch_shuffle_pool_dropout import flax_given_masks, port_masks


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_batches(variant, n, samples):
    """n train batches of `samples` distinct synthetic samples (the JAX
    package's own dataset, as test_torch_resnet_train.batches)."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    ds = JaxSynthetic(JaxSegConfig(**{**KW, **dict(model=variant)}),
                      mode='train')
    return [tuple(np.stack(a) for a in zip(*(ds.get(k * samples + i)
                                             for i in range(samples))))
            for k in range(n)]


def check_model_steps(variant, n, tmp_path, samples=4, masks=None,
                      weights=None, cut=None):
    """n float32 steps of `samples` samples each of the JAX build_train_step
    and the port's from the same weights (`weights`, or the tests' seeded
    draw) on the same batches: each step's loss within 1e-5 relative;
    params, batch_stats and their EMA within 1e-4. With `masks` (a
    `numpy_masks` draw), the JAX step is traced under `flax_given_masks`
    and the port's step takes the same masks through build_train_step's
    `dropout_masks`, every step. With `cut`, both packages build the model
    with those constructor switches (a cut depth). Returns the port's
    trainer."""
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.models.registry import model_class
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.step import build_train_step as jax_train_step
    from rtseg_tpu_torch.models.registry import _PLAIN
    from rtseg_tpu_torch.train import trainer as trainer_mod
    kw = dict(train_bs=samples, synthetic_len=3 * samples)
    jcfg = jax_config(variant, **kw)
    jcfg.resolve_schedule(train_num=kw['synthetic_len'])
    if cut:
        fmodel = model_class(variant)(num_class=jcfg.num_class, **cut)
        build = lambda cfg, device=None: _PLAIN[variant](  # noqa: E731
            num_class=cfg.num_class, device=device, **cut)
        v = weights or random_jax_variables(build(jcfg), seed=17)
    else:
        fmodel, build = jax_get_model(jcfg), trainer_mod.get_model
        v = variables(variant) if weights is None else weights
    opt = get_optimizer(jcfg)
    step = jax_train_step(jcfg, fmodel, opt, _mesh())
    state = jax_state(v, opt)
    data = train_batches(variant, n, samples)
    jlosses = []
    with flax_given_masks(masks or (lambda *a: None)):
        for imgs, msks in data:
            state, m = step(state, jnp.asarray(imgs), jnp.asarray(msks))
            jlosses.append(float(m['loss']))
    want = jax.device_get(
        {'variables': {'params': state.params,
                       'batch_stats': state.batch_stats},
         'ema': {'params': state.ema_params,
                 'batch_stats': state.ema_batch_stats}})
    registry = trainer_mod.get_model
    trainer_mod.get_model = build
    try:
        trainer = SegTrainer(port_config(variant, tmp_path, **kw),
                             device='cpu', variables=v)
    finally:
        trainer_mod.get_model = registry
    if masks is not None:
        source = port_masks(masks)
        trainer.train_step = build_train_step(
            trainer.config, dropout_masks=lambda k: source)
    tlosses = []
    for imgs, msks in data:
        trainer.state, m = trainer.train_step(
            trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
        tlosses.append(float(m['loss']))
    assert trainer.state.step == n
    assert tlosses == pytest.approx(jlosses, rel=1e-5)
    assert_trees_close(to_jax_variables(trainer.model), want['variables'],
                       1e-4, 'params/batch_stats')
    assert_trees_close(to_jax_variables(trainer.ema_model), want['ema'],
                       1e-4, 'ema')
    return trainer


@pytest.mark.parametrize('variant,samples', [('lednet', 16), ('aglnet', 4)])
def test_one_train_step_matches_jax(variant, samples, tmp_path):
    check_model_steps(variant, 1, tmp_path, samples=samples)


def test_lednet_validation_equals_the_jax_eval_step(tmp_path):
    """LEDNet's 1/8-resolution logits through the fused head: confusion
    matrices equal to the JAX eval step's (fused head and Pallas confusion
    matrix, interpret mode)."""
    check_validation('lednet', tmp_path)
