"""PyTorch port against the JAX package: the uint8 flip+normalize tail
(rtseg_tpu_torch/ops/augment.py) and the steps built with norm_coeffs.

* `_norm_lut`, `device_normalize` and `device_flip_norm` bit-equal to the
  JAX package's and to its host path (`transforms.flip_norm_pack`: flip,
  then f32(f32(v) * scale) + bias) on seeded uint8 batches, with the
  ImageNet coefficients and the identity ones, every flag combination.
* A train step built with norm_coeffs on a uint8 batch and its flags is
  bit-equal (loss, weights, BatchNorm statistics, EMA) to the step on the
  same batch flipped and normalized by the host path; the eval and predict
  steps with norm_coeffs give the confusion matrix and predictions of the
  float steps, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu.data.transforms import _norm_coeffs, flip_norm_pack
from rtseg_tpu.ops import augment as jaug
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.ops import augment as taug
from rtseg_tpu_torch.train import (SegTrainer, build_eval_step,
                                   build_predict_step, build_train_step)
from rtseg_tpu_torch.utils.convert import to_jax_variables
from test_torch_resnet_train import assert_trees_close

COEFFS = {'imagenet': _norm_coeffs(False), 'identity': _norm_coeffs(True)}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, b=4, h=6, w=10):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    images[0, 0, 0] = (0, 255, 128)           # both ends of the table
    masks = rng.randint(0, 19, (b, h, w)).astype(np.int32)
    # every (h_flip, v_flip) combination
    flags = np.array([(0, 0), (1, 0), (0, 1), (1, 1)][:b], np.uint8)
    return images, masks, flags


def _host(images, masks, flags, coeffs):
    """The JAX package's host path, sample by sample."""
    identity = coeffs == 'identity'
    out = [flip_norm_pack(i, m, bool(f[0]), bool(f[1]), identity)
           for i, m, f in zip(images, masks, flags)]
    return (np.stack([o[0] for o in out]),
            np.stack([np.asarray(o[1], np.int32) for o in out]))


@pytest.mark.parametrize('coeffs', sorted(COEFFS))
def test_norm_lut_and_normalize_are_bit_equal(coeffs):
    scale, bias = COEFFS[coeffs]
    np.testing.assert_array_equal(taug._norm_lut(scale, bias),
                                  jaug._norm_lut(scale, bias))
    images, _, _ = _batch()
    got = taug.device_normalize(torch.from_numpy(images), scale, bias)
    assert got.dtype == torch.float32 and got.shape == images.shape
    want = np.asarray(jaug.device_normalize(jnp.asarray(images), scale,
                                            bias))
    np.testing.assert_array_equal(got.numpy(), want)
    host, _ = _host(images, images[..., 0], np.zeros((4, 2), np.uint8),
                    coeffs)
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize('coeffs', sorted(COEFFS))
def test_flip_norm_is_bit_equal(coeffs):
    scale, bias = COEFFS[coeffs]
    images, masks, flags = _batch(1)
    x, m = taug.device_flip_norm(torch.from_numpy(images),
                                 torch.from_numpy(masks),
                                 torch.from_numpy(flags), scale, bias)
    jx, jm = jaug.device_flip_norm(jnp.asarray(images), jnp.asarray(masks),
                                   jnp.asarray(flags), scale, bias)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    hx, hm = _host(images, masks, flags, coeffs)
    np.testing.assert_array_equal(x.numpy(), hx)
    np.testing.assert_array_equal(m.numpy(), hm)
    assert m.dtype == torch.int32


def test_normalize_of_float_input_raises():
    """The table covers uint8 alone: a float batch raises where the JAX
    package would take a multiply-add that no path uses."""
    scale, bias = COEFFS['imagenet']
    x = torch.zeros((2, 3, 4, 3))
    with pytest.raises(TypeError, match='uint8'):
        taug.device_normalize(x, scale, bias)
    with pytest.raises(TypeError, match='uint8'):
        taug.device_flip_norm(x, torch.zeros((2, 3, 4), dtype=torch.int32),
                              torch.zeros((2, 2), dtype=torch.uint8), scale,
                              bias)


# ------------------------------------------------------------------ steps

H, W = 32, 64
KW = dict(model='bisenetv2', use_aux=True, num_class=19, dataset='synthetic',
          crop_h=H, crop_w=W, train_bs=4, val_bs=4, synthetic_len=8,
          total_epoch=2, loss_type='ohem', compute_dtype='float32',
          optimizer_type='adam', random_seed=6, use_tb=False, use_obs=False,
          base_workers=0)


def test_steps_with_norm_coeffs_equal_the_host_normalized_steps(tmp_path):
    """Two steps with norm_coeffs on uint8 batches with flags against two
    steps on the host path's float batches: loss, weights, statistics and
    EMA equal bit for bit; then the eval step's confusion matrix and the
    predict step's predictions on a uint8 batch equal the float ones."""
    scale, bias = COEFFS['imagenet']
    rng = np.random.RandomState(3)
    data = [(rng.randint(0, 256, (4, H, W, 3)).astype(np.uint8),
             rng.randint(0, 19, (4, H, W)).astype(np.int32),
             np.array([(0, 0), (1, 0), (0, 1), (1, 1)], np.uint8))
            for _ in range(2)]
    raw = SegTrainer(SegConfig(**KW, save_dir=str(tmp_path / 'a')),
                     device='cpu')
    host = SegTrainer(SegConfig(**KW, save_dir=str(tmp_path / 'b')),
                      device='cpu')
    raw_step = build_train_step(raw.config, norm_coeffs=(scale, bias))
    for images, masks, flags in data:
        _, m_raw = raw_step(raw.state, torch.from_numpy(images),
                            torch.from_numpy(masks), torch.from_numpy(flags))
        x, m = _host(images, masks, flags, 'imagenet')
        _, m_host = host.train_step(host.state, torch.from_numpy(x),
                                    torch.from_numpy(m))
        assert torch.equal(m_raw['loss'], m_host['loss'])
    for a, b in ((raw.model, host.model), (raw.ema_model, host.ema_model)):
        assert_trees_close(to_jax_variables(a), to_jax_variables(b), 0.0,
                           'norm_coeffs step')
    with pytest.raises(ValueError, match='norm_coeffs'):
        host.train_step(host.state, torch.from_numpy(x),
                        torch.from_numpy(m), torch.from_numpy(flags))

    images, masks, _ = data[0]
    x, _ = _host(images, masks, np.zeros((4, 2), np.uint8), 'imagenet')
    model = raw.ema_model
    u8, f32 = torch.from_numpy(images), torch.from_numpy(x)
    cm_raw = build_eval_step(raw.config, model, 'cpu', (scale, bias))(
        u8, torch.from_numpy(masks))
    cm_host = build_eval_step(raw.config, model, 'cpu')(
        f32, torch.from_numpy(masks))
    assert torch.equal(cm_raw, cm_host) and int(cm_raw.sum()) > 0
    assert torch.equal(
        build_predict_step(raw.config, model, 'cpu', (scale, bias))(u8),
        build_predict_step(raw.config, model, 'cpu')(f32))
