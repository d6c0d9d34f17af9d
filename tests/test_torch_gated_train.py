"""PyTorch port against the JAX package: float32 train steps of the
models with Flax Dense gates from the same variables on the same batches
as the JAX build_train_step (each step's loss within 1e-5 relative,
params, batch_stats and their EMA within 1e-4, at a peak LR of 1e-3;
tests/test_torch_resnet_train.py): three of CGNet, one of RegSeg, one of
DFANet at a cut depth; and the validation of CGNet, whose float32 logits
come at 1/8 through the fused head, against the JAX eval step.

RegSeg runs one step: by the third, float32 rounding alone parts two CPU
runs of the port from weights 1e-7 apart by 3.4e-4 in the loss, as far as
the port parts from the JAX step. DFANet's float32 forward at its full
depth and random weights is chaotic (tests/test_torch_gated_models.py),
so its step runs with one block a stage (`repeat_times=(1, 1, 1)`) and
16 samples: at the other tests' 4, the BatchNorms of its FC attentions
(1x1 maps) see 4 values a channel, and two CPU runs of the port from
weights 1e-7 apart part its stem kernel by 9.5e-5 to 2.0e-4 beyond the
1e-4 tolerance after one step; at 16, by 4.7e-6 to 7.5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.models.dfanet import DFANet
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.train import trainer as trainer_mod
from rtseg_tpu_torch.utils.convert import (random_jax_variables,
                                           to_jax_variables)
from test_torch_resnet_train import (KW, NC, _mesh, assert_trees_close,
                                     check_steps, check_validation,
                                     jax_config, jax_state, port_config)

DFANET_CUT = dict(repeat_times=(1, 1, 1))
DFANET_SAMPLES = 16


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_three_cgnet_train_steps_match_jax(tmp_path):
    check_steps('cgnet', 3, tmp_path)


def test_one_regseg_train_step_matches_jax(tmp_path):
    check_steps('regseg', 1, tmp_path)


def test_one_dfanet_train_step_at_cut_depth_matches_jax(tmp_path,
                                                        monkeypatch):
    """The trainer builds the cut model (its get_model patched), the JAX
    step the Flax model of the same depth; the checks of check_steps."""
    from rtseg_tpu.models.dfanet import DFANet as FlaxDFANet
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.step import build_train_step as jax_train_step
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    v = random_jax_variables(DFANet(NC, **DFANET_CUT), seed=17)
    # one epoch of 3 steps of DFANET_SAMPLES, as the others' of 4
    kw = dict(train_bs=DFANET_SAMPLES, synthetic_len=3 * DFANET_SAMPLES)
    jcfg = jax_config('dfanet', **kw)
    jcfg.resolve_schedule(train_num=kw['synthetic_len'])
    opt = get_optimizer(jcfg)
    step = jax_train_step(jcfg, FlaxDFANet(num_class=NC, **DFANET_CUT), opt,
                          _mesh())
    state = jax_state(v, opt)
    ds = JaxSynthetic(JaxSegConfig(**{**KW, 'model': 'dfanet', **kw}),
                      mode='train')
    imgs, msks = (np.stack(a) for a in zip(*(ds.get(i) for i in
                                             range(DFANET_SAMPLES))))
    state, m = step(state, jnp.asarray(imgs), jnp.asarray(msks))
    want = jax.device_get(
        {'variables': {'params': state.params,
                       'batch_stats': state.batch_stats},
         'ema': {'params': state.ema_params,
                 'batch_stats': state.ema_batch_stats}})

    monkeypatch.setattr(trainer_mod, 'get_model',
                        lambda cfg, device=None: DFANet(
                            NC, device=device, **DFANET_CUT))
    trainer = SegTrainer(port_config('dfanet', tmp_path, **kw),
                         device='cpu', variables=v)
    trainer.state, got = trainer.train_step(
        trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
    assert float(got['loss']) == pytest.approx(float(m['loss']), rel=1e-5)
    assert_trees_close(to_jax_variables(trainer.model), want['variables'],
                       1e-4, 'params/batch_stats')
    assert_trees_close(to_jax_variables(trainer.ema_model), want['ema'],
                       1e-4, 'ema')


def test_cgnet_validation_equals_the_jax_eval_step(tmp_path):
    check_validation('cgnet', tmp_path)
