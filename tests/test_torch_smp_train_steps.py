"""PyTorch port against the JAX package: float32 train steps of the smp hub
(DeepLabV3+, PSPNet, MAnet on ResNet-18, FPN on MiT-b0) from the same
seeded variables on the same batches as the JAX build_train_step, at a
peak LR of 1e-3: each step's loss within 1e-5 relative; params,
batch_stats and their EMA within 1e-4.

Both packages take the same dropout masks (ASPP's Dropout, FPN's and
PSPNet's Dropout2d) and MiT's drop-path masks: the JAX step is traced with
Flax's nn.Dropout intercepted and jax.random.bernoulli replaced inside
MiT's blocks (tests/test_torch_smp_models.py `smp_masks`; the JAX step
draws its rng at trace time, so they hold every step), and the port's
step takes the same masks through `dropout_masks`.

PSPNet's decoder reads the stride-8 feature, but its layer3 and layer4
run in training: their BatchNorm statistics move in the JAX step, and the
check covers every leaf.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.train import SegTrainer, build_train_step
from rtseg_tpu_torch.utils.convert import to_jax_variables
from test_torch_last_train import train_batches
from test_torch_resnet_train import (KW, PORT_ONLY, _mesh,
                                     assert_trees_close, jax_state)
from test_torch_smp_models import smp_masks, variables


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_smp_steps(encoder, decoder, n, tmp_path, samples=4, config=None):
    """n float32 steps of `samples` samples of the JAX step and the port's
    with equal masks: each loss within 1e-5 relative; params, batch_stats
    and their EMA within 1e-4. `config` adds config switches of both
    packages. Returns the port's trainer."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.step import build_train_step as jax_train_step
    kw = dict(KW, model='smp', encoder=encoder, decoder=decoder,
              train_bs=samples, synthetic_len=3 * samples, **(config or {}))
    jcfg = JaxSegConfig(**kw)
    jcfg.resolve(num_devices=1)
    jcfg.resolve_schedule(train_num=kw['synthetic_len'])
    opt = get_optimizer(jcfg)
    step = jax_train_step(jcfg, jax_get_model(jcfg), opt, _mesh())
    v = variables(encoder, decoder)
    state = jax_state({'batch_stats': {}, **v}, opt)
    data = train_batches('smp', n, samples)
    trainer = SegTrainer(SegConfig(**kw, **PORT_ONLY, save_dir=str(tmp_path)),
                         device='cpu', variables=v)
    jlosses, tlosses = [], []
    with smp_masks(11) as source:
        for imgs, msks in data:
            state, m = step(state, jnp.asarray(imgs), jnp.asarray(msks))
            jlosses.append(float(m['loss']))
        trainer.train_step = build_train_step(
            trainer.config, dropout_masks=lambda k: source)
        for imgs, msks in data:
            trainer.state, m = trainer.train_step(
                trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
            tlosses.append(float(m['loss']))
    want = jax.device_get(
        {'variables': {'params': state.params,
                       'batch_stats': state.batch_stats},
         'ema': {'params': state.ema_params,
                 'batch_stats': state.ema_batch_stats}})
    assert trainer.state.step == n
    assert tlosses == pytest.approx(jlosses, rel=1e-5)
    got = to_jax_variables(trainer.model)
    if not want['variables']['batch_stats']:        # MiT with FPN: no BN
        for tree in want.values():
            tree.pop('batch_stats')
    assert_trees_close(got, want['variables'], 1e-4, 'params/batch_stats')
    assert_trees_close(to_jax_variables(trainer.ema_model), want['ema'],
                       1e-4, 'ema')
    return trainer


@pytest.mark.parametrize('encoder,decoder,steps', [
    ('resnet18', 'deeplabv3p', 3), ('resnet18', 'pspnet', 3),
    ('resnet18', 'manet', 3), ('mit_b0', 'fpn', 3)])
def test_train_steps_match_jax(encoder, decoder, steps, tmp_path):
    check_smp_steps(encoder, decoder, steps, tmp_path)
