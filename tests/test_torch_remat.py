"""PyTorch port against the JAX package: config.remat, the training
forward under torch.utils.checkpoint (rtseg_tpu_torch/train/step.py
`_make_apply_train`, nn/modules.py `Recompute`).

* Three float32 train steps of FPN on MiT-b0 under Adam with remat on
  both sides (the JAX step under jax.checkpoint), the same drop-path and
  dropout masks in both packages, at the start of a long warmup as
  tests/test_torch_optim_tail.py says why: each step's loss within 1e-5
  relative; params and their EMA within 1e-4.
* The port's step with remat equals its step without, bit for bit (loss,
  weights, BatchNorm running statistics, EMA, Adam's moments), over two
  steps of ENet (Dropout2d), FPN on MiT-b0 (drop path, Dropout2d,
  LayerNorm, GroupNorm) and BiSeNetv2 with its aux heads, the masks drawn
  from the step's own generator: the recompute moves no running
  statistic a second time and asks the generator for no mask (it replays
  the first pass's), and leaves no mask source bound and no statistic
  frozen.
"""

import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.nn import BatchNorm, DropoutMasks, dropout_modules
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.utils.convert import to_jax_variables
from test_torch_optim_tail import WARMUP
from test_torch_resnet_train import assert_trees_close
from test_torch_smp_train_steps import check_smp_steps


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_remat_step_matches_the_jax_remat_step(tmp_path):
    trainer = check_smp_steps('mit_b0', 'fpn', 3, tmp_path,
                              config=dict(WARMUP, optimizer_type='adam',
                                          remat=True))
    assert trainer.config.remat
    group = trainer.state.optimizer.param_groups[0]
    assert group['betas'][0] != 0.9 and 'momentum' not in group


MODELS = {'enet': dict(model='enet'),
          'mit_b0_fpn': dict(model='smp', encoder='mit_b0', decoder='fpn'),
          'bisenetv2_aux': dict(model='bisenetv2', use_aux=True,
                                loss_type='ohem')}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_remat_equals_the_step_without_it(name, tmp_path, monkeypatch):
    """Two steps with and without remat from the same weights: equal bit
    for bit, the recompute's mask requests none (the masks drawn equal in
    number the forwards' dropout calls without remat)."""
    draws = []
    real = DropoutMasks.__call__

    def counted(self, path, shape, keep_prob):
        draws[-1] += 1
        return real(self, path, shape, keep_prob)
    monkeypatch.setattr(DropoutMasks, '__call__', counted)
    kw = dict(dict(num_class=19, dataset='synthetic', crop_h=32, crop_w=32,
                   train_bs=4, val_bs=4, synthetic_len=8, total_epoch=2,
                   compute_dtype='float32', optimizer_type='adam',
                   use_aux=False, random_seed=2, use_tb=False,
                   use_obs=False, base_workers=0), **MODELS[name])
    runs = []
    for remat in (False, True):
        t = SegTrainer(SegConfig(**kw, remat=remat,
                                 save_dir=str(tmp_path / str(remat))),
                       device='cpu')
        losses = []
        draws.append(0)
        for imgs, msks in t.train_loader:
            _, m = t.train_step(t.state, imgs, msks)
            losses.append(m['loss'])
        runs.append((t, losses))
        drops = dropout_modules(t.model)
        assert all(m.masks is None for _, m in drops)
        assert not any(m.frozen_stats for m in t.model.modules()
                       if isinstance(m, BatchNorm))
    (a, la), (b, lb) = runs
    assert all(torch.equal(x, y) for x, y in zip(la, lb)), (la, lb)
    assert draws[0] == draws[1]
    if name != 'bisenetv2_aux':
        assert draws[0] > 0          # the model has dropout or drop path
    for x, y in ((a.model, b.model), (a.ema_model, b.ema_model)):
        assert_trees_close(to_jax_variables(y), to_jax_variables(x), 0.0,
                           f'{name} remat')
    names = dict(a.model.named_parameters())
    for n, p in b.model.named_parameters():
        sa, sb = a.state.optimizer.state[names[n]], b.state.optimizer.state[p]
        assert all(torch.equal(sa[k], sb[k]) for k in sa), n


def test_recompute_replays_masks_and_freezes_statistics_only_inside():
    """Recompute's contexts on their own: the first pass records the bound
    source's masks, the recompute hands them back in order without asking
    the source, and refuses a request the first pass did not make; a
    BatchNorm in the recompute normalizes but moves no statistic."""
    from rtseg_tpu_torch.nn import Dropout, Recompute, bind_dropout
    net = torch.nn.Sequential(BatchNorm(3), Dropout(0.5))
    net.train()
    asked = []

    def source(path, shape, keep_prob):
        asked.append(path)
        return torch.rand(shape) < keep_prob
    first, again = Recompute(net)()
    x = torch.randn(2, 3, 4, 4)
    bn = net[0].bn
    with bind_dropout(net, source), first:
        y1 = net(x)
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    with again:
        y2 = net(x)
    assert torch.equal(y1, y2) and asked == ['1']
    assert torch.equal(bn.running_mean, stats[0])
    assert torch.equal(bn.running_var, stats[1])
    assert not net[0].frozen_stats and net[1].masks is None
    _, unrecorded = Recompute(net)()
    with pytest.raises(RuntimeError, match='recompute asked'):
        with unrecorded:
            net(x)
