"""PyTorch port against the JAX package: MixTransformer (models/mit.py)
and the normalizations it and FPN need (nn/modules.py LayerNorm,
GroupNorm).

* LayerNorm and GroupNorm compute Flax's fast variance, E[x^2] - E[x]^2
  in float32. On inputs with a large mean that formula loses what
  F.layer_norm and F.group_norm keep, so the test input makes the loss
  exact and deterministic: values 4096 + 4k, whose squares and sums are
  exact in float32, with means whose square rounds. The port equals Flax
  there; the library calls (F.group_norm on a contiguous input) differ.
* MiT's attention in query slices equals the attention in one call.
* The drop-path schedule, its per-sample masks, and the first block that
  draws nothing; MiT-b0 with FPN's training forward near the Flax model
  run in float64 with the same drop-path and dropout masks.
* MiT-b0 with FPN's bf16 logits of Flax's type (bf16) near Flax's bf16
  logits (the ENet precedent, tests/test_torch_pool_models.py).
* FPN's parameter trees on the encoders other than ResNet-18,
  MobileNetV2 and MiT-b0 (tests/test_torch_smp_models.py has those).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtseg_tpu_torch.models.mit import MixTransformer, attention
from rtseg_tpu_torch.nn import DropPath, bind_dropout, group_norm, layer_norm
from test_torch_smp_models import (OTHER_ENCODERS, check_tree, flax_model,
                                   images, port_model, variables)
from test_torch_smp_train import \
    test_training_forward_and_batch_stats_match_flax as smp_train_forward


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact_large_mean(shape, seed):
    """4096 + 4k, k in [-4, 4]: every square is a multiple of 16 below
    2^28, so squares and their sums over 8 values are exact in float32,
    and so are the means; the square of a mean on a half-integer is not."""
    k = np.random.RandomState(seed).randint(-4, 5, shape)
    return (4096 + 4 * k).astype(np.float32)


def _affine(c, seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(0.5, 1.5, c).astype(np.float32),
            rs.uniform(-0.2, 0.2, c).astype(np.float32))


def test_layer_norm_computes_flax_fast_variance():
    import flax.linen as fnn
    x = _exact_large_mean((4, 3, 5, 8), 0)
    w, b = _affine(8, 1)
    want = np.asarray(fnn.LayerNorm(epsilon=1e-6).apply(
        {'params': {'scale': w, 'bias': b}}, jnp.asarray(x)))
    args = (torch.from_numpy(w), torch.from_numpy(b))
    got = layer_norm(torch.from_numpy(x), *args, 1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    lib = F.layer_norm(torch.from_numpy(x), (8,), *args, 1e-6).numpy()
    assert np.abs(lib - want).max() > 1e-2
    # in bf16: float32 statistics, the result in bf16 as Flax's dtype=bf16
    xb = jnp.asarray(x[..., :8] - 4096.0, jnp.bfloat16)
    want = np.asarray(fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16).apply(
        {'params': {'scale': w, 'bias': b}}, xb)).astype(np.float32)
    got = layer_norm(torch.from_numpy(x - 4096.0).to(torch.bfloat16), *args,
                     1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


def test_group_norm_computes_flax_fast_variance():
    """32 groups of 2 channels over 2x2 positions: 8 values a group."""
    import flax.linen as fnn
    x = _exact_large_mean((3, 2, 2, 64), 2)
    w, b = _affine(64, 3)
    want = np.asarray(fnn.GroupNorm(num_groups=32, epsilon=1e-5).apply(
        {'params': {'scale': w, 'bias': b}}, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    args = (torch.from_numpy(w), torch.from_numpy(b))
    got = group_norm(xt, 32, *args, 1e-5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    # the library's kernel for a contiguous NCHW input keeps the variance
    # (its CPU kernel for channels_last happens to take sums of squares:
    # which formula F.group_norm uses depends on the layout and device)
    lib = F.group_norm(xt.contiguous(), 32, *args, 1e-5)
    assert np.abs(lib.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_attention_in_query_slices_equals_one_call():
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(2, 2, n, 16).astype(np.float32))
               for n in (50, 12, 12))
    whole = attention(q, k, v)
    for chunk in (2 * 2 * 12 * 7, 2 * 2 * 12):   # 7 rows, 1 row a slice
        np.testing.assert_allclose(attention(q, k, v, chunk).numpy(),
                                   whole.numpy(), atol=1e-6, rtol=1e-6)
    # the scale is sqrt(d) rounded to the activation type, as JAX rounds it
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q[..., :8], k[..., :8],
                                                 v[..., :8]))
    want = jax.nn.softmax(
        jnp.einsum('nhqd,nhkd->nhqk', jnp.asarray(qb.float().numpy(),
                                                  jnp.bfloat16),
                   jnp.asarray(kb.float().numpy(), jnp.bfloat16))
        / jnp.sqrt(jnp.asarray(8, jnp.bfloat16)), axis=-1)
    want = jnp.einsum('nhqk,nhkd->nhqd', want,
                      jnp.asarray(vb.float().numpy(), jnp.bfloat16))
    got = attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize('arch', ['mit_b0', 'mit_b2'])
def test_drop_path_schedule_and_masks(arch):
    """The linear schedule over the whole depth (0.1 at the last block),
    each block's two DropPaths at its rate; the first block's rate is 0
    and it asks for no mask; a mask is one draw a sample, (N, 1, 1, 1)."""
    from rtseg_tpu.models.mit import MIT_DROP_PATH, MIT_SETTINGS
    model = MixTransformer(arch).train()
    total = sum(MIT_SETTINGS[arch][1])
    rates = [m.rate for n, m in model.named_modules()
             if isinstance(m, DropPath) and n.endswith('drop_attn')]
    assert rates == pytest.approx(
        [MIT_DROP_PATH * i / (total - 1) for i in range(total)])
    asked = []

    def source(path, shape, keep_prob):
        asked.append((path, shape, keep_prob))
        return torch.ones(shape, dtype=torch.bool)

    x = torch.from_numpy(images(32, n=3)).permute(0, 3, 1, 2)
    if arch == 'mit_b0':
        with torch.no_grad(), bind_dropout(model, source):
            model(x)
        assert len(asked) == 2 * (total - 1)
        assert not any(p.startswith('block1_0.') for p, _, _ in asked)
        assert {s for _, s, _ in asked} == {(3, 1, 1, 1)}
        assert asked[0] == ('block1_1.drop_attn', (3, 1, 1, 1),
                            pytest.approx(1 - MIT_DROP_PATH / (total - 1)))
        drop = DropPath(0.5).train()
        drop.masks = lambda p, s, k: torch.tensor([True, False]).reshape(s)
        y = drop(torch.ones(2, 3, 4, 5))
        assert torch.equal(y[0], torch.full((3, 4, 5), 2.0))
        assert torch.equal(y[1], torch.zeros(3, 4, 5))


def test_mit_fpn_training_forward_with_equal_drop_paths_matches_flax():
    smp_train_forward('mit_b0', 'fpn')


def test_bf16_logits_take_the_flax_models_type():
    """MiT's Dense layers run in the activation type: bf16 logits, near
    Flax's bf16 logits, within 5% of their largest value, or no farther
    than the Flax model's own bf16 logits lie from its float32 ones."""
    fmodel = flax_model('mit_b0', 'fpn')
    x = images(64, seed=3)
    apply = jax.jit(lambda v, x: fmodel.apply(v, x, False))
    v = jax.tree.map(jnp.asarray, variables('mit_b0', 'fpn'))
    want = np.asarray(apply(v, jnp.asarray(x, jnp.bfloat16)))
    want32 = np.asarray(apply(v, jnp.asarray(x)))
    assert want.dtype == jnp.bfloat16
    model = port_model('mit_b0', 'fpn').eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    want = want.astype(np.float32)
    own = float(np.abs(want - want32).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= \
        max(0.05 * float(np.abs(want).max()), own)


@pytest.mark.parametrize('encoder', OTHER_ENCODERS)
def test_fpn_parameter_tree_on_the_other_encoders(encoder):
    check_tree(encoder, 'fpn')
