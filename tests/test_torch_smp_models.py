"""PyTorch port against the JAX package: the smp encoder-decoder hub
(models/smp.py) and its MixTransformer encoder (models/mit.py).

Here: the parameter trees of every decoder on ResNet-18, MobileNetV2 and
(the five it takes) MiT-b0, and of the KD teacher pair, against the Flax
init tree (`jax.eval_shape`, no compile), both ways through
utils/convert.py; the registry's and `build_smp_model`'s
refusals with the JAX package's messages; and the helpers the other smp
test files share: the models, their seeded variables, and the equal
dropout and drop-path masks of both packages (`smp_masks`).

FPN's trees on the other encoders are in tests/test_torch_mit.py, eval
logits in tests/test_torch_smp_eval.py, the training forwards in
tests/test_torch_smp_train.py, the train steps in
tests/test_torch_smp_train_steps.py and tests/test_torch_kd.py.
"""

from contextlib import contextmanager
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model, get_teacher_model
from rtseg_tpu_torch.models.smp import (ENCODER_CHANNELS,
                                        MIT_UNSUPPORTED_DECODERS,
                                        SMP_DECODERS, build_smp_model)
from rtseg_tpu_torch.utils.convert import (_flatten, load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)
from test_torch_shuffle_pool_dropout import flax_given_masks, numpy_masks

NC = 19
MIT_DECODERS = tuple(d for d in SMP_DECODERS
                     if d not in MIT_UNSUPPORTED_DECODERS)
OTHER_ENCODERS = ('resnet34', 'resnet50', 'resnet101', 'resnet152',
                  'mit_b1', 'mit_b2', 'mit_b3', 'mit_b4', 'mit_b5')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def side(encoder, decoder):
    """The input side of a check: 64, or what PAN's three VALID 2x2 pools
    of the deepest map need (128 at output stride 16, 256 at 32)."""
    if decoder == 'pan':
        return 256 if encoder.startswith('mit_') else 128
    return 64


def flax_model(encoder, decoder):
    from rtseg_tpu.models.smp import build_smp_model as jax_build
    return jax_build(encoder, decoder, NC)


@lru_cache(maxsize=None)
def variables(encoder, decoder, seed=0):
    return random_jax_variables(build_smp_model(encoder, decoder, NC),
                                seed=seed)


def port_model(encoder, decoder, seed=0):
    model = build_smp_model(encoder, decoder, NC)
    load_jax_variables(model, variables(encoder, decoder, seed))
    return model


def images(s, n=2, seed=42):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (n, s, s, 3)).astype(np.float32)


@contextmanager
def flax_drop_path_masks(get):
    """Inside the block (tracing included), MixTransformer's drop path in
    the Flax model keeps the samples of get('<Block scope>/drop_attn' or
    '.../drop_ffn', (N, 1, 1, 1), keep_prob) instead of a draw of
    jax.random.bernoulli: the Block's calls are followed through
    flax.linen.intercept_methods, and jax.random.bernoulli is replaced for
    the block. Nothing in the JAX package changes."""
    import flax.linen as fnn
    from rtseg_tpu.models.mit import Block
    stack = []
    bernoulli = jax.random.bernoulli

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, Block) and \
                context.method_name == '__call__':
            stack.append(['/'.join(context.module.scope.path), 0])
            try:
                return next_fun(*args, **kwargs)
            finally:
                stack.pop()
        return next_fun(*args, **kwargs)

    def given(key, p=0.5, shape=None):
        if not stack:
            return bernoulli(key, p, shape)
        top = stack[-1]
        branch = ('drop_attn', 'drop_ffn')[top[1]]
        top[1] += 1
        return jnp.asarray(get(f'{top[0]}/{branch}', tuple(shape), p))

    jax.random.bernoulli = given
    try:
        with fnn.intercept_methods(interceptor):
            yield
    finally:
        jax.random.bernoulli = bernoulli


def port_smp_masks(get):
    """The port's mask source over the draws of `get`: a drop path at
    module path `a.b.drop_attn` asks for `a/b/drop_attn` with its (N, 1,
    1, 1) shape; a Dropout or Dropout2d at `a.b` for the Flax scope
    `a/b/drop`, NHWC, handed back NCHW."""
    def source(path, shape, keep_prob):
        if path.endswith(('drop_attn', 'drop_ffn')):
            return torch.from_numpy(get(path.replace('.', '/'), shape,
                                        keep_prob))
        n, c, h, w = shape
        m = get(path.replace('.', '/') + '/drop', (n, h, w, c), keep_prob)
        return torch.from_numpy(m).permute(0, 3, 1, 2)
    return source


@contextmanager
def smp_masks(seed):
    """(port mask source, context for the Flax side): the same numpy-drawn
    dropout and drop-path masks in both packages."""
    get = numpy_masks(seed)
    with flax_given_masks(get), flax_drop_path_masks(get):
        yield port_smp_masks(get)


def flax_tree(fmodel, s):
    """{Flax path: shape} of the Flax init tree (`jax.eval_shape`)."""
    tree = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)), False))
    return {k: tuple(v.shape) for k, v in _flatten(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), tree)).items()}


def check_tree(encoder, decoder):
    """Both ways through utils/convert.py: the port's Flax paths and shapes
    equal the Flax init tree's, and a tree of that shape loads into the
    port strictly (every leaf to a module tensor of its shape, every
    module tensor filled)."""
    model = build_smp_model(encoder, decoder, NC)
    want = flax_tree(flax_model(encoder, decoder), side(encoder, decoder))
    got = {k: tuple(v.shape)
           for k, v in _flatten(to_jax_variables(model)).items()}
    assert got == want
    tree = {}
    for path, shape in want.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.full(shape, 0.5, np.float32)
    load_jax_variables(model, tree)
    assert all(bool((t == 0.5).all()) for k, t in model.state_dict().items()
               if not k.endswith('num_batches_tracked'))


# the decoders on ResNet-18, MobileNetV2 and MiT-b0, and the teacher pair;
# FPN on the other encoders is in tests/test_torch_mit.py
PAIRS = ([('resnet18', d) for d in SMP_DECODERS]
         + [('mobilenet_v2', d) for d in SMP_DECODERS]
         + [('mit_b0', d) for d in MIT_DECODERS]
         + [('resnet101', 'deeplabv3p')])


@pytest.mark.parametrize('encoder,decoder', PAIRS)
def test_parameter_tree_equals_the_flax_init_tree(encoder, decoder):
    check_tree(encoder, decoder)


def test_registry_builds_smp_and_the_teacher_and_refuses_heads():
    """`model='smp'` builds the hub's model from config.encoder and
    config.decoder; aux and detail heads raise ValueError (the JAX step
    would fail later, unpacking the one output); the teacher is built from
    the teacher_* switches only under kd_training."""
    cfg = dict(model='smp', encoder='resnet18', decoder='fpn', num_class=NC)
    model = get_model(SegConfig(**cfg))
    assert type(model).__name__ == 'GenericSegModel'
    assert model.decoder_name == 'fpn'
    with pytest.raises(ValueError, match='Model smp does not support '
                                         'auxiliary heads'):
        get_model(SegConfig(**cfg, use_aux=True))
    with pytest.raises(ValueError, match='Model smp does not support '
                                         'detail heads'):
        get_model(SegConfig(**cfg, use_detail_head=True))
    kd = dict(num_class=NC, teacher_encoder='resnet101',
              teacher_decoder='deeplabv3p')
    assert get_teacher_model(SegConfig(**kd)) is None
    teacher = get_teacher_model(SegConfig(**kd, kd_training=True))
    assert teacher.decoder_name == 'deeplabv3p'
    assert teacher.encoder.kind == 'resnet101'


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize('encoder,decoder', [
    ('resnet18', 'segformer'), ('vgg16', 'fpn'), ('mit_b0', 'deeplabv3'),
    ('mit_b2', 'deeplabv3p'), ('mit_b1', 'linknet'), ('mit_b0', 'unetpp')])
def test_build_refusals_carry_the_jax_messages(encoder, decoder):
    from rtseg_tpu.models.smp import build_smp_model as jax_build
    want = _jax_error(lambda: jax_build(encoder, decoder, NC))
    assert _jax_error(lambda: build_smp_model(encoder, decoder, NC)) == want


def test_teacher_refusal_carries_the_jax_message():
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_teacher_model as jax_teacher
    kw = dict(num_class=NC, kd_training=True, teacher_encoder='resnet18',
              teacher_decoder='segformer')
    want = _jax_error(lambda: jax_teacher(JaxSegConfig(**kw)))
    assert _jax_error(lambda: get_teacher_model(SegConfig(**kw))) == want
    assert want == 'Unsupported teacher decoder type: segformer'


def test_every_encoder_is_known_to_both_packages():
    from rtseg_tpu.models.smp import ENCODER_CHANNELS as JAX_CHANNELS
    from rtseg_tpu.models.smp import SMP_DECODERS as JAX_DECODERS
    assert ENCODER_CHANNELS == JAX_CHANNELS
    assert SMP_DECODERS == JAX_DECODERS
