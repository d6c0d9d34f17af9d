"""PyTorch port against the JAX package: the models built on dropout and
the 2x2 argmax pool and unpool, ENet and MiniNet (dropout) and SegNet (the
pool and unpool at all five stages; ENet at two), whose logits all come at
full size, at their registry defaults on a small input, with the checks of
tests/test_torch_resnet_models.py: parameter paths equal to the Flax init
tree's, eval logits within 1e-4 deferred and not, a training forward's
outputs and batch_stats against the Flax model run in float64, and the
bf16 logits' type.

The dropout models' training forwards run with equal masks: the test
draws one a Flax scope path with numpy, the JAX model applies it through
Flax's intercepted nn.Dropout and the port's through its mask source
(tests/test_torch_shuffle_pool_dropout.py). A torch generator cannot draw
Flax's masks, which fold the module path into a threefry key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.nn import Dropout, bind_dropout
from rtseg_tpu_torch.utils.convert import _flatten, to_jax_variables
from test_torch_backbone import assert_near_float64, flax_train_forward
from test_torch_resnet_models import (H, W, _input, check_eval_logits,
                                      check_parameter_paths,
                                      check_training_forward, flax_model,
                                      port_model, variables)
from test_torch_shuffle_pool_dropout import (flax_given_masks, numpy_masks,
                                             port_masks)

VARIANTS = ('enet', 'mininet', 'segnet')
# the Flax scope paths of each dropout model's dropouts, and the NHWC
# shape of their masks on the 4 x 64 x 128 input
DROPOUTS = {
    'enet': [(f'Bottleneck_{i}/Dropout_0/drop',
              (4, 16, 32, 64) if i < 5 else
              (4, 8, 16, 128) if i < 22 else
              (4, 16, 32, 64) if i < 25 else (4, 32, 64, 16))
             for i in range(27)],
    'mininet': [(f'ConvModule_{i}/Dropout_0/drop', s) for i, s in enumerate(
        [(4, 4, 8, 96)] * 4 + [(4, 2, 4, 192), (4, 1, 2, 386),
                               (4, 1, 2, 386), (4, 2, 4, 192),
                               (4, 8, 16, 96)])],
}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant', VARIANTS)
def test_parameter_paths_equal_the_flax_init_tree(variant):
    check_parameter_paths(variant)


@pytest.mark.parametrize('defer', [False, True])
@pytest.mark.parametrize('variant', VARIANTS)
def test_eval_logits_match_flax(variant, defer):
    check_eval_logits(variant, defer)


def test_segnet_training_forward_and_batch_stats_match_flax():
    check_training_forward('segnet')


@pytest.mark.parametrize('variant', ['enet', 'mininet'])
def test_dropout_training_forward_and_batch_stats_match_flax(variant):
    """The training forward with equal masks: each dropout of the Flax
    model is asked for its mask once a trace, at the path and shape the
    port's module asks for, and the outputs and batch_stats are held to
    the Flax float64 run."""
    get, seen = numpy_masks(5), []
    x = _input(seed=7, n=4)
    with flax_given_masks(get, seen):
        (out32, bs32), (out64, bs64) = flax_train_forward(
            flax_model(variant), variables(variant), x)
    assert seen == DROPOUTS[variant] * 2        # a float32 and a float64
    model = port_model(variant).train()
    asked = []

    def source(path, shape, keep_prob):
        asked.append(path)
        return port_masks(get)(path, shape, keep_prob)

    with torch.no_grad(), bind_dropout(model, source):
        got = model(torch.from_numpy(x))
    assert [p.replace('.', '/') + '/drop' for p in asked] == \
        [p for p, _ in DROPOUTS[variant]]
    assert_near_float64(got.numpy(), out64, out32, 'logits')
    got_bs = dict(_flatten(to_jax_variables(model)['batch_stats']))
    bs32, bs64 = dict(_flatten(bs32)), dict(_flatten(bs64))
    assert got_bs.keys() == bs64.keys()
    for k in bs64:
        assert_near_float64(got_bs[k], bs64[k], bs32[k], '/'.join(k))


@pytest.mark.parametrize('variant', ['enet', 'mininet'])
def test_dropout_models_refuse_training_without_masks(variant):
    """A training forward with no mask source raises, as the Flax model
    raises without a 'dropout' rng; out of training the dropouts are the
    identity (the eval logits above)."""
    model = port_model(variant).train()
    rates = sorted({m.rate for m in model.modules()
                    if isinstance(m, Dropout)})
    assert rates == ([0.01, 0.1] if variant == 'enet' else [0.25])
    with pytest.raises(RuntimeError, match='keep masks'), torch.no_grad():
        model(torch.from_numpy(_input(n=2)))


@pytest.mark.parametrize('variant', VARIANTS)
def test_bf16_logits_take_the_flax_models_type(variant):
    """bf16 logits of Flax's type (bf16), near the Flax model's bf16
    logits: within 5% of their largest value, or no farther than the Flax
    model's own bf16 logits lie from its float32 ones. At these random
    weights ENet's do by 26% (bf16 rounding through 27 bottlenecks), so
    its bf16 logits are not held to the float32 ones as
    tests/test_torch_gated_models.py holds the others'."""
    fmodel = flax_model(variant)
    x = np.random.RandomState(3).uniform(-1.5, 1.5,
                                         (2, H, W, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x: fmodel.apply(v, x, False))
    v = jax.tree.map(jnp.asarray, variables(variant))
    want = np.asarray(apply(v, jnp.asarray(x, jnp.bfloat16)))
    want32 = np.asarray(apply(v, jnp.asarray(x)))
    assert want.dtype == jnp.bfloat16
    model = port_model(variant).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    want = want.astype(np.float32)
    own = float(np.abs(want - want32).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= \
        max(0.05 * float(np.abs(want).max()), own)


def test_enet_and_segnet_keep_int8_index_maps(monkeypatch):
    """The downsampling stages hand their unpools int8 index maps, an
    eighth of torch's int64 ones: ENet's two and SegNet's five."""
    from rtseg_tpu_torch.ops import pool
    seen = []
    pool_fn = pool.max_pool_argmax_2x2

    def spy(x):
        out = pool_fn(x)
        seen.append(out[1].dtype)
        return out

    monkeypatch.setattr(pool, 'max_pool_argmax_2x2', spy)
    for variant in ('enet', 'segnet'):
        with torch.inference_mode():
            port_model(variant).eval()(torch.from_numpy(_input(n=1)))
    assert seen == [torch.int8] * 7
