"""PyTorch port against the JAX package: the ops of the last six models of
the zoo. `channel_shuffle` and `channel_split` (ops/shuffle.py); the 2x2
argmax pool and its unpool (ops/pool.py), values, int8 indices and input
gradients bit for bit in float32 and bf16, with forced ties and odd
sizes; `Dropout` and `Dropout2d` (nn/modules.py) with the masks of a real
Flax nn.Dropout bit for bit, the masks drawn from a generator, and the
refusal of a training forward without a mask source; the train step's
per-step dropout generator.

It also holds the helpers by which the model and train-step tests give
the JAX package and the port the same dropout masks: `numpy_masks` draws
a mask a Flax scope path with numpy, `flax_given_masks` substitutes
Flax's nn.Dropout.__call__ with `flax.linen.intercept_methods` so that
the JAX model applies them (nothing in the JAX package changes), and
`port_masks` is the port's mask source over the same draws.
"""

import zlib
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.nn import (Dropout, Dropout2d, DropoutMasks,
                                bind_dropout, conv1x1, conv3x3)
from rtseg_tpu_torch.ops import (channel_shuffle, channel_split,
                                 max_pool_argmax_2x2, max_unpool_2x2)
from rtseg_tpu_torch.ops.pool import (max_pool_argmax_2x2_nchw,
                                      max_unpool_2x2_nchw)
from rtseg_tpu_torch.ops.shuffle import channel_shuffle_nchw

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


# ---------------------------------------------------------- mask helpers

def numpy_masks(seed):
    """get(Flax scope path, NHWC mask shape, keep probability) -> bool
    numpy mask, drawn with numpy from `seed` and the path, the same on
    every call for a path and shape."""
    cache = {}

    def get(path, shape, keep_prob):
        key = (path, tuple(shape), keep_prob)
        if key not in cache:
            rs = np.random.RandomState([seed, zlib.crc32(path.encode())])
            cache[key] = rs.uniform(size=tuple(shape)) < keep_prob
        return cache[key]

    return get


@contextmanager
def flax_given_masks(get, seen=None):
    """Inside the block (tracing included), every training call of Flax's
    nn.Dropout returns Flax's formula, select(keep, x / keep_prob, 0),
    with keep = get('/'.join(its scope path), its mask shape, keep_prob)
    instead of a draw from the 'dropout' rng; `seen` collects (path,
    shape) of the calls."""
    import flax.linen as fnn
    from jax import lax

    def interceptor(next_fun, args, kwargs, context):
        m = context.module
        if not (isinstance(m, fnn.Dropout)
                and context.method_name == '__call__') \
                or m.deterministic or m.rate == 0.0:
            return next_fun(*args, **kwargs)
        x = args[0]
        shape = list(x.shape)
        for d in m.broadcast_dims:
            shape[d] = 1
        path = '/'.join(m.scope.path)
        if seen is not None:
            seen.append((path, tuple(shape)))
        keep_prob = 1.0 - m.rate
        keep = jnp.broadcast_to(jnp.asarray(get(path, shape, keep_prob)),
                                x.shape)
        return lax.select(keep, x / keep_prob, jnp.zeros_like(x))

    with fnn.intercept_methods(interceptor):
        yield


def port_masks(get):
    """The port's mask source over the draws of `get`: a module at path
    `a.b` asks for the Flax scope `a/b/drop`, NHWC, handed back NCHW."""
    def source(path, shape, keep_prob):
        n, c, h, w = shape
        m = get(path.replace('.', '/') + '/drop', (n, h, w, c), keep_prob)
        return torch.from_numpy(m).permute(0, 3, 1, 2)
    return source


# ---------------------------------------------------------------- shuffle

@pytest.mark.parametrize('groups,c', [(2, 8), (3, 12), (4, 8), (2, 2)])
def test_channel_shuffle_equals_jax(groups, c):
    from rtseg_tpu.ops.shuffle import channel_shuffle as jax_shuffle
    x = np.random.RandomState(c).randn(2, 3, 5, c).astype(np.float32)
    want = np.asarray(jax_shuffle(jnp.asarray(x), groups))
    got = channel_shuffle(torch.from_numpy(x), groups)
    np.testing.assert_array_equal(got.numpy(), want)
    # channel g*cpg + i went to i*groups + g
    cpg = c // groups
    for g in range(groups):
        for i in range(cpg):
            np.testing.assert_array_equal(want[..., i * groups + g],
                                          x[..., g * cpg + i])
    # the NCHW form on a channels_last tensor: the same values, and the
    # result stays channels_last
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    y = channel_shuffle_nchw(xt, groups)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('num', [2, 4])
def test_channel_split_equals_jax(num):
    from rtseg_tpu.ops.shuffle import channel_split as jax_split
    x = np.random.RandomState(num).randn(2, 3, 4, 8).astype(np.float32)
    want = jax_split(jnp.asarray(x), num)
    got = channel_split(torch.from_numpy(x), num)
    assert len(got) == len(want) == num
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match='evenly'):
        channel_split(torch.zeros(1, 2, 2, 6), 4)


# ------------------------------------------------------------ argmax pool

def _tie_heavy(shape, seed):
    """Small integers: most 2x2 windows hold a tie, some a four-way one."""
    rs = np.random.RandomState(seed)
    x = rs.randint(-2, 3, shape).astype(np.float32)
    x[:, :2, :2, :] = 1.0                  # a four-way tie in each corner
    return x


@pytest.mark.parametrize('shape', [(2, 8, 12, 5), (2, 7, 9, 3),
                                   (1, 5, 6, 4)],
                         ids=['even', 'odd', 'odd_rows'])
@pytest.mark.parametrize('dt', DTYPES, ids=['float32', 'bfloat16'])
def test_argmax_pool_values_and_int8_indices_equal_jax(dt, shape):
    from rtseg_tpu.ops.pool import max_pool_argmax_2x2 as jax_pool
    jdt, tdt = dt
    for seed, x in enumerate((_tie_heavy(shape, 0),
                              np.random.RandomState(1).randn(*shape)
                              .astype(np.float32))):
        jv, ji = jax_pool(jnp.asarray(x, jdt))
        tv, ti = max_pool_argmax_2x2(torch.from_numpy(x).to(tdt))
        assert ti.dtype == torch.int8 and tv.dtype == tdt
        assert tuple(tv.shape) == (shape[0], shape[1] // 2, shape[2] // 2,
                                   shape[3])
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.float().numpy(),
                                      np.asarray(jv.astype(jnp.float32)))
    # ties go to the first maximum in row-major order
    assert int(ti[0, 0, 0, 0]) in range(4)
    tv, ti = max_pool_argmax_2x2(torch.ones(1, 2, 2, 1, dtype=tdt))
    assert int(ti) == 0


@pytest.mark.parametrize('dt', DTYPES, ids=['float32', 'bfloat16'])
def test_argmax_pool_gradient_equals_jax_grad_on_ties(dt):
    """jax.grad splits a tie of `maximum` evenly (0.25 each on a four-way
    tie); so does the port, where F.max_pool2d gives all to one input."""
    from rtseg_tpu.ops.pool import max_pool_argmax_2x2 as jax_pool
    jdt, tdt = dt
    x = _tie_heavy((2, 9, 10, 4), 3)
    g = np.random.RandomState(4).randn(2, 4, 5, 4).astype(np.float32)
    want = jax.grad(lambda a: (jax_pool(a)[0].astype(jnp.float32)
                               * g).sum())(jnp.asarray(x, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    (max_pool_argmax_2x2(xt)[0].float() * torch.from_numpy(g)).sum() \
        .backward()
    assert xt.grad.dtype == tdt
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # a four-way tie: a quarter each
    quarter = float(torch.tensor(g[0, 0, 0, 0]).to(tdt)) / 4
    np.testing.assert_array_equal(xt.grad[0, :2, :2, 0].float().numpy(),
                                  np.full((2, 2), quarter, np.float32))
    ref = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    torch.nn.functional.max_pool2d(ref, 2)[0, 0, 0, 0].backward()
    assert float(ref.grad.sum()) == float(ref.grad.max()) == 1.0


@pytest.mark.parametrize('out_hw', [None, (9, 11)], ids=['exact', 'padded'])
@pytest.mark.parametrize('dt', DTYPES, ids=['float32', 'bfloat16'])
def test_max_unpool_equals_jax_with_its_gradient(dt, out_hw):
    from rtseg_tpu.ops.pool import max_pool_argmax_2x2 as jax_pool
    from rtseg_tpu.ops.pool import max_unpool_2x2 as jax_unpool
    jdt, tdt = dt
    x = _tie_heavy((2, 9, 11, 3), 5)
    _, ji = jax_pool(jnp.asarray(x, jdt))
    _, ti = max_pool_argmax_2x2(torch.from_numpy(x).to(tdt))
    v = np.random.RandomState(6).randn(2, 4, 5, 3).astype(np.float32)
    want = jax_unpool(jnp.asarray(v, jdt), ji, out_hw)
    got = max_unpool_2x2(torch.from_numpy(v).to(tdt), ti, out_hw)
    assert got.dtype == tdt
    assert tuple(got.shape) == tuple(want.shape) == \
        (2,) + (out_hw or (8, 10)) + (3,)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the gradient: each output position's to the value placed there
    g = np.random.RandomState(7).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda a: (jax_unpool(a, ji, out_hw).astype(jnp.float32)
                             * g).sum())(jnp.asarray(v, jdt))
    vt = torch.from_numpy(v).to(tdt).requires_grad_(True)
    (max_unpool_2x2(vt, ti, out_hw).float() * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_array_equal(vt.grad.float().numpy(),
                                  np.asarray(jg.astype(jnp.float32)))


def test_nchw_forms_keep_channels_last():
    """The models' NCHW forms run the NHWC construction on the
    channels_last view: the same values, and channels_last outputs."""
    x = _tie_heavy((2, 8, 10, 6), 8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    v, i = max_pool_argmax_2x2_nchw(xt)
    wv, wi = max_pool_argmax_2x2(torch.from_numpy(x))
    assert v.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(v.permute(0, 2, 3, 1), wv)
    assert torch.equal(i.permute(0, 2, 3, 1), wi)
    u = max_unpool_2x2_nchw(v, i)
    assert u.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(u.permute(0, 2, 3, 1), max_unpool_2x2(wv, wi))


# ---------------------------------------------------------------- dropout

def _signed_input(seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(0.5, 3.0, (2, 6, 7, 5))
            * np.sign(rs.randn(2, 6, 7, 5))).astype(np.float32)


@pytest.mark.parametrize('rate', [0.01, 0.1, 0.25, 0.5])
@pytest.mark.parametrize('dt', DTYPES, ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('channel_wise', [False, True],
                         ids=['Dropout', 'Dropout2d'])
def test_dropout_with_flax_masks_equals_flax(channel_wise, dt, rate):
    """The JAX package's Dropout(2d) run by Flax with a 'dropout' rng; its
    keep mask read off the output (no input is 0); the port's module with
    that mask gives the same values bit for bit: where(keep, x / keep_prob,
    0) with keep_prob rounded to the input's type (in bf16, x / 0.9 with a
    float32 0.9 rounds otherwise for about a third of the values)."""
    from rtseg_tpu.nn.modules import Dropout as JaxDropout
    from rtseg_tpu.nn.modules import Dropout2d as JaxDropout2d
    jdt, tdt = dt
    x = _signed_input(int(rate * 100))
    jcls, tcls = ((JaxDropout2d, Dropout2d) if channel_wise
                  else (JaxDropout, Dropout))
    want = jcls(rate).apply({}, jnp.asarray(x, jdt), True,
                            rngs={'dropout': jax.random.PRNGKey(3)})
    want = np.asarray(want.astype(jnp.float32))
    keep = want != 0
    if channel_wise:
        assert (keep == keep[:, :1, :1, :]).all()
        keep = keep[:, :1, :1, :]
    module = tcls(rate).train()
    asked = []

    def given(path, shape, keep_prob):
        asked.append((shape, keep_prob))
        return torch.from_numpy(keep).permute(0, 3, 1, 2)

    with bind_dropout(module, given):
        got = module(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    assert got.dtype == tdt
    assert asked == [((2, 5, 1, 1) if channel_wise else (2, 5, 6, 7),
                      1.0 - rate)]
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  want)
    # out of training, the identity
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert module.eval()(x_t) is x_t


def test_dropout_identity_at_rate_zero_and_zeros_at_one():
    x = torch.from_numpy(_signed_input(0)).permute(0, 3, 1, 2)
    assert Dropout(0.0).train()(x) is x
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))


@pytest.mark.parametrize('cls,rate', [(Dropout, 0.25), (Dropout2d, 0.2)])
def test_drawn_masks_keep_the_share_and_broadcast(cls, rate):
    """Masks from a generator keep about 1 - rate of the values (of the
    channels for Dropout2d, one draw a sample and channel shared by all
    its pixels); the same seed draws the same masks, another seed others."""
    x = torch.ones(8, 32, 24, 24)
    module = cls(rate).train()

    def run(seed):
        with bind_dropout(module, DropoutMasks(
                torch.Generator().manual_seed(seed))):
            return module(x)

    y = run(1)
    kept = (y != 0).float()
    if cls is Dropout2d:
        assert torch.equal(kept, kept[:, :, :1, :1].expand_as(kept))
        share, n = float(kept[:, :, 0, 0].mean()), 8 * 32
    else:
        share, n = float(kept.mean()), kept.numel()
    # within five standard deviations of the keep share
    assert abs(share - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    assert torch.equal(y, run(1)) and not torch.equal(y, run(2))
    np.testing.assert_allclose(float(y.max()), 1.0 / (1 - rate), rtol=1e-6)


def test_training_forward_without_a_mask_source_raises():
    """As Flax raises without a 'dropout' rng: never quietly
    deterministic; the source is unbound after the block."""
    module = Dropout(0.1).train()
    x = torch.ones(1, 2, 3, 3)
    with pytest.raises(RuntimeError, match='keep masks'):
        module(x)
    with bind_dropout(module, DropoutMasks(torch.Generator())):
        module(x)
    with pytest.raises(RuntimeError, match='keep masks'):
        module(x)
    with pytest.raises(ValueError, match='bool of shape'):
        with bind_dropout(module, lambda p, s, k: torch.ones(1, 2, 1, 1,
                                                              dtype=bool)):
            module(x)


def test_conv1x1_and_conv3x3_match_flax_parameter_trees():
    from rtseg_tpu.nn.modules import conv1x1 as jax_conv1x1
    from rtseg_tpu.nn.modules import conv3x3 as jax_conv3x3
    for jf, tf in ((jax_conv1x1, conv1x1), (jax_conv3x3, conv3x3)):
        for stride, bias in ((1, False), (2, True)):
            tree = jax.eval_shape(lambda: jf(6, stride, bias).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4))))
            m = tf(4, 6, stride, bias)
            k = tree['params']['conv']['kernel'].shape
            assert tuple(m.conv.weight.shape) == (k[3], k[2], k[0], k[1])
            assert ('bias' in tree['params']['conv']) == bias
            assert m.conv.stride == (stride, stride)


def test_train_step_seeds_its_dropout_generator_from_seed_and_step():
    """The per-step seed: random_seed + 1 and the step (the JAX step folds
    the step into PRNGKey(random_seed + 1)), distinct across steps and
    seeds."""
    from rtseg_tpu_torch.train.step import dropout_seed
    seeds = {dropout_seed(s, k) for s in range(3) for k in range(100)}
    assert len(seeds) == 300
    assert dropout_seed(1, 5) == (2 << 32) + 5
