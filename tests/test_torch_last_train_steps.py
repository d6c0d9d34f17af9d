"""PyTorch port against the JAX package: float32 train steps of ENet and
MiniNet (dropout), SegNet (the argmax pool and unpool) and Lite-HRNet
from the same variables on the same batches as the JAX build_train_step
(each step's loss within 1e-5 relative, params, batch_stats and their EMA
within 1e-4, at a peak LR of 1e-3; tests/test_torch_last_train.py), and
SegNet's validation, whose logits come at full size, against the JAX eval
step; then a resumed MiniNet run against an uninterrupted one.

ENet and MiniNet run with equal dropout masks: the JAX step is traced with
Flax's nn.Dropout intercepted to apply masks drawn by the test (the JAX
step draws its rng at trace time, so they hold every step), and the
port's step takes the same masks through `dropout_masks`. MiniNet runs
three steps; ENet one: its third step's loss parts from the JAX step's
by 6.8e-5.

SegNet runs one step of 8 samples from Flax's initializers. From the
tests' seeded draw at 4 samples the JAX model's own float32 forward,
run op by op, puts the first loss 2.3e-5 from its float64 run (the
port's 2.2e-7), and its jitted step parts from the port's by as much;
at 8 samples from Flax's initializers both lie within 7.6e-7 of it.

Lite-HRNet runs one step of 16 samples with one CCW block a branch
(`repeat=1`; its forward is held at full depth by
tests/test_torch_litehrnet.py). Its BatchNorms over the pooled weights see
a value a sample and channel: at full depth two CPU runs of the port from
weights 1e-7 apart (zoo_check_spread.py) part its stem kernel by 1.0e-2
to 7.6e-2 after one step of 4 and by 2.6e-4 to 5.7e-4 of 16, and the
port parts from the JAX step by 1.4e-4 (the head's BatchNorm variance);
at `repeat=1` and 16 samples by 1.6e-5 to 2.5e-5 and 1.1e-5.
"""

import pytest
import torch

from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train import SegTrainer, build_train_step
from rtseg_tpu_torch.train.step import dropout_seed
from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                           to_jax_variables)
from test_torch_last_train import check_model_steps, train_batches
from test_torch_resnet_train import (assert_trees_close, check_validation,
                                     port_config, variables)
from test_torch_shuffle_pool_dropout import numpy_masks



@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant,steps', [('enet', 1), ('mininet', 3)])
def test_train_steps_with_equal_masks_match_jax(variant, steps, tmp_path):
    check_model_steps(variant, steps, tmp_path, masks=numpy_masks(11))


def test_one_segnet_train_step_from_the_flax_init_matches_jax(tmp_path):
    model = get_model(port_config('segnet', tmp_path))
    check_model_steps('segnet', 1, tmp_path, samples=8,
                      weights=flax_init_variables(model, seed=3))


def test_one_lite_hrnet_train_step_at_cut_depth_matches_jax(tmp_path):
    check_model_steps('lite_hrnet', 1, tmp_path, samples=16,
                      cut=dict(repeat=1))


def test_segnet_validation_equals_the_jax_eval_step(tmp_path):
    """SegNet's full-size logits through the identity-size argmax:
    confusion matrices equal to the JAX eval step's."""
    check_validation('segnet', tmp_path)


def test_mininet_resumes_with_the_masks_of_an_uninterrupted_run(tmp_path):
    """MiniNet's dropout masks come from the step's generator, seeded from
    random_seed + 1 and the step: two steps in one run equal one step, a
    checkpoint, a new trainer resumed from it, and one more step (weights,
    batch_stats, EMA and SGD momentum). Different steps draw different
    masks, and without the seeding the resumed step would differ."""
    data = train_batches('mininet', 2, 4)
    kw = dict(total_epoch=2, save_ckpt=True)

    def step(trainer, i):
        imgs, msks = data[i]
        trainer.state, m = trainer.train_step(
            trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
        return float(m['loss'])

    whole = SegTrainer(port_config('mininet', tmp_path / 'a', **kw),
                       device='cpu', variables=variables('mininet'))
    losses = [step(whole, 0), step(whole, 1)]

    first = SegTrainer(port_config('mininet', tmp_path / 'b', **kw),
                       device='cpu', variables=variables('mininet'))
    assert step(first, 0) == losses[0]
    first.save_ckpt()
    first._ckpt_writer.join()     # the write runs on the writer thread
    resumed = SegTrainer(port_config('mininet', tmp_path / 'b', **kw,
                                     load_ckpt=True, resume_training=True,
                                     load_ckpt_path=str(tmp_path / 'b' /
                                                        'last.ckpt')),
                         device='cpu')
    assert resumed.state.step == 1
    assert step(resumed, 1) == losses[1]
    for a, b in ((whole.model, resumed.model),
                 (whole.ema_model, resumed.ema_model)):
        assert_trees_close(to_jax_variables(b), to_jax_variables(a), 0.0,
                           'resumed')
    for pa, pb in zip(whole.state.optimizer.state.values(),
                      resumed.state.optimizer.state.values()):
        assert torch.equal(pa['momentum_buffer'], pb['momentum_buffer'])

    # the step's masks are those of a CPU generator seeded from the seed
    # and the step: seeded as step 1, the first step trains otherwise
    def first_loss(offset):
        from rtseg_tpu_torch.nn import DropoutMasks
        t = SegTrainer(port_config('mininet', tmp_path / 'c'), device='cpu',
                       variables=variables('mininet'))
        seed = t.config.random_seed
        t.train_step = build_train_step(
            t.config, dropout_masks=lambda k: DropoutMasks(
                torch.Generator().manual_seed(dropout_seed(seed, k + offset))))
        return step(t, 0)

    assert first_loss(0) == losses[0]
    assert first_loss(1) != losses[0]
