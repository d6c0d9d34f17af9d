"""PyTorch port against the JAX package: BiSeNetv2 and the eval slice.

The same seeded Flax-shaped variables (made with numpy by the port) drive
the Flax model and the port's model; the same synthetic batches drive the
JAX eval step (fused head and Pallas confusion matrix, interpret mode on
the CPU) and the port's SegTrainer eval path on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train import SegTrainer, build_predict_step
from rtseg_tpu_torch.utils.convert import random_jax_variables

NC, H, W = 19, 64, 128


def _config(**kw):
    base = dict(model='bisenetv2', use_aux=True, num_class=NC,
                dataset='synthetic', crop_h=H, crop_w=W, val_bs=4,
                synthetic_len=16, compute_dtype='float32', random_seed=3,
                load_ckpt=False)
    base.update(kw)
    return SegConfig(**base)


@pytest.fixture(scope='module')
def variables():
    return random_jax_variables(get_model(_config()), seed=0)


@pytest.fixture(scope='module')
def flax_logits(variables):
    """The Flax model's eval logits, full-size and deferred, on one input
    (each apply compiled once for the module)."""
    from rtseg_tpu.models.bisenetv2 import BiSeNetv2
    from rtseg_tpu.ops import set_defer_final_upsample
    x = np.random.RandomState(42).uniform(-1.5, 1.5,
                                          (2, H, W, 3)).astype(np.float32)
    model = BiSeNetv2(num_class=NC, use_aux=True)
    v = jax.tree.map(jnp.asarray, variables)
    out = {}
    for defer in (False, True):
        try:
            set_defer_final_upsample(defer)
            out[defer] = np.asarray(jax.jit(
                lambda v, x: model.apply(v, x, False))(v, jnp.asarray(x)))
        finally:
            set_defer_final_upsample(False)
    return x, out


@pytest.mark.parametrize('defer', [False, True])
def test_bisenetv2_eval_logits_match_flax(variables, flax_logits, defer):
    x, want = flax_logits
    trainer = SegTrainer(_config(), device='cpu', variables=variables)
    with torch.inference_mode():
        got = trainer.model(torch.from_numpy(x), defer_upsample=defer)
    expect_hw = (H // 8, W // 8) if defer else (H, W)
    assert tuple(got.shape) == (2,) + expect_hw + (NC,)
    np.testing.assert_allclose(got.numpy(), want[defer], atol=1e-4,
                               rtol=1e-4)


def test_eval_slice_matches_jax_eval_step(variables):
    """JAX build_eval_step (fused head + Pallas confusion matrix) against
    the port's validate() on the same synthetic val batches."""
    from jax.sharding import Mesh
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.ops import fused_path
    from rtseg_tpu.train.state import TrainState
    from rtseg_tpu.train.step import build_eval_step
    from rtseg_tpu.utils.metrics import iou_from_cm as jax_iou

    cfg = _config(val_bs=8)
    trainer = SegTrainer(cfg, device='cpu', variables=variables)
    assert trainer.eval_step.fused is False          # auto -> plain on CPU
    miou = trainer.validate()

    jcfg = JaxSegConfig(model='bisenetv2', use_aux=True, num_class=NC,
                        dataset='synthetic', crop_h=H, crop_w=W, val_bs=8,
                        compute_dtype='float32', fused_head=True,
                        use_pallas_metrics=True, use_ema=False)
    jcfg.resolve(num_devices=1)
    model = jax_get_model(jcfg)
    params = jax.tree.map(jnp.asarray, variables['params'])
    stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=(), ema_params=params,
                       ema_batch_stats=stats)
    assert fused_path((8, H // 8, W // 8, NC), (H, W)) == 'pallas'
    mesh = Mesh(np.array(jax.devices()[:1]), ('data',))
    step = build_eval_step(jcfg, model, mesh, use_ema=False)
    assert step.defer_upsample
    want = np.zeros((NC, NC), np.int64)
    for imgs, msks in trainer.val_loader:
        want += np.asarray(step(state, jnp.asarray(imgs.numpy()),
                                jnp.asarray(msks.numpy())), np.int64)

    got = trainer.last_cm
    px = int(want.sum())
    assert px == 16 * H * W and int(got.sum()) == px
    assert int(np.abs(got - want).sum()) <= 2 * 1e-4 * px
    assert abs(miou - float(jax_iou(want).mean())) <= 1e-3


def test_fused_head_on_cpu_runs_the_plain_versions(variables):
    cfg = _config(fused_head=True, use_pallas_metrics=True)
    trainer = SegTrainer(cfg, device='cpu', variables=variables)
    assert trainer.eval_step.fused
    fused_miou = trainer.validate()
    plain = SegTrainer(_config(fused_head=False, use_pallas_metrics=False),
                       device='cpu', variables=variables)
    assert abs(plain.validate() - fused_miou) <= 1e-3
    assert np.abs(plain.last_cm - trainer.last_cm).sum() \
        <= 2 * 1e-4 * plain.last_cm.sum()
    imgs, _ = next(iter(trainer.val_loader))
    preds = build_predict_step(cfg, trainer.model, 'cpu')(imgs)
    assert preds.dtype == torch.int32 and tuple(preds.shape) == (4, H, W)


def test_validate_flushes_to_host_before_int32_overflow(variables,
                                                        monkeypatch):
    import rtseg_tpu_torch.train.trainer as trainer_mod
    trainer = SegTrainer(_config(), device='cpu', variables=variables)
    trainer.validate()
    whole = trainer.last_cm.copy()
    # a bound of 2.5 batches forces a flush before the third batch
    monkeypatch.setattr(trainer_mod, '_INT32_MAX', int(2.5 * 4 * H * W))
    trainer.validate()
    np.testing.assert_array_equal(trainer.last_cm, whole)


def test_validate_rejects_a_batch_past_int32(variables):
    trainer = SegTrainer(_config(), device='cpu', variables=variables)
    # expanded views: 2^31 label pixels without the memory
    imgs = torch.zeros(1, 1, 1, 3).expand(1, 65536, 32768, 3)
    msks = torch.zeros(1, 1, 1, dtype=torch.int32).expand(1, 65536, 32768)
    trainer.val_loader = [(imgs, msks)]
    with pytest.raises(ValueError, match='int32 max'):
        trainer.validate()


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        SegTrainer(_config())


def test_port_refuses_what_it_does_not_implement():
    for lever in ('pack_fullres', 's2d_stem', 'detail_remat', 'hires_remat'):
        with pytest.raises(NotImplementedError, match=lever):
            get_model(_config(**{lever: True}))
    # every model of the JAX registry is ported (tests/test_torch_zoo_*.py,
    # tests/test_torch_*_models.py), and so is the smp encoder-decoder hub
    # (tests/test_torch_smp_models.py), which without a decoder raises the
    # JAX package's ValueError
    with pytest.raises(ValueError, match='Unsupported decoder type'):
        get_model(_config(model='smp', use_aux=False))
    # training is ported: with the aux heads the training forward returns
    # the logits and the four aux logits
    model = get_model(_config())
    with torch.no_grad():
        out = model.train()(torch.zeros(2, H, W, 3))
    assert isinstance(out, tuple) and len(out[1]) == 4
    assert tuple(out[0].shape) == (2, H, W, NC)


def test_val_loader_matches_jax_loader():
    """Same samples, same order, the ragged tail padded with ignored
    labels, as the JAX package's val loader."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.loader import ShardedLoader
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    from rtseg_tpu_torch.data.loader import get_val_loader
    cfg = _config(val_bs=5, crop_h=16, crop_w=24)
    loader = get_val_loader(cfg)
    jcfg = JaxSegConfig(dataset='synthetic', num_class=NC, crop_h=16,
                        crop_w=24, synthetic_len=16)
    jloader = ShardedLoader(JaxSynthetic(jcfg, mode='val'), 5,
                            shuffle=False, drop_last=False)
    ours, theirs = list(loader), list(jloader)
    assert len(ours) == len(theirs) == 4
    for (ti, tm), (ji, jm) in zip(ours, theirs):
        assert ti.is_contiguous() and tm.is_contiguous()
        assert tm.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(tm.numpy(), jm)
    assert (ours[-1][1][1:] == 255).all()
