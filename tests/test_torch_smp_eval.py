"""PyTorch port against the JAX package: the smp hub's eval logits, and
the pitfalls its port has to get right.

Eval logits within 1e-4 of the Flax model's in float32 from the same
seeded variables, and the deferred logits at each decoder's stride: the
nine decoders on ResNet-18, MobileNetV2 with DeepLabV3 (dilated to output
stride 8) and FPN, MiT-b0 with FPN, MAnet and PAN, at 64x64 (PAN at 128x128, and 256x256 on MiT:
its pool ladder halves the deepest map three times). Then MAnet's PAB
scramble, ASPP's rate convs through the phases of the map, smp's uniform
dilation against models/backbone.py's surgical one, and PSPNet's eval
encoder stopping after layer2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.models.backbone import ResNet
from rtseg_tpu_torch.models.smp import (SMP_DECODERS, Encoder, PABlock,
                                        build_smp_model)
from rtseg_tpu_torch.utils.convert import (load_jax_variables,
                                           random_jax_variables)
from test_torch_smp_models import (NC, flax_model, images, port_model,
                                   side, variables)

EVAL_PAIRS = ([('resnet18', d) for d in SMP_DECODERS]
              + [('mobilenet_v2', 'deeplabv3'), ('mobilenet_v2', 'fpn'),
                 ('mit_b0', 'fpn'), ('mit_b0', 'manet'), ('mit_b0', 'pan')])
# output stride of the deferred logits
STRIDE = {'unet': 1, 'unetpp': 1, 'linknet': 1, 'manet': 1, 'fpn': 4,
          'pan': 4, 'deeplabv3p': 4, 'pspnet': 8, 'deeplabv3': 8}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('encoder,decoder', EVAL_PAIRS)
def test_eval_logits_match_flax(encoder, decoder):
    """Full-size logits within 1e-4 of the Flax model's; the deferred
    logits at the decoder's stride, whose align-corners upsample
    (ops/resize.py, held to the JAX package's by the port's ops tests) is
    the full-size logits exactly."""
    from rtseg_tpu_torch.ops.resize import resize_bilinear
    s = side(encoder, decoder)
    x = images(s)
    fmodel = flax_model(encoder, decoder)
    want = np.asarray(jax.jit(lambda v, x: fmodel.apply(v, x, False))(
        jax.tree.map(jnp.asarray, variables(encoder, decoder)),
        jnp.asarray(x)))
    model = port_model(encoder, decoder).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        low = model(torch.from_numpy(x), defer_upsample=True)
    assert tuple(got.shape) == (2, s, s, NC)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    stride = STRIDE[decoder]
    assert tuple(low.shape) == (2, s // stride, s // stride, NC)
    assert torch.equal(resize_bilinear(low, (s, s)), got)


@pytest.mark.parametrize('h,w,rate', [(8, 16, 12), (8, 8, 36), (13, 29, 5),
                                      (24, 48, 24)])
def test_atrous_conv_equals_the_dilated_conv(h, w, rate):
    """ASPP's rate convs through the d x d phases of the map (space to
    batch) equal the dilated conv, with a bias, on maps whose sides are
    and are not multiples of the rate; a channels_last result."""
    from rtseg_tpu_torch.models.smp import atrous_conv
    torch.manual_seed(rate)
    conv = torch.nn.Conv2d(6, 5, 3, padding=rate, dilation=rate)
    x = torch.randn(2, 6, h, w).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, 1, rate,
                                          rate)
        got = atrous_conv(x, conv)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_pab_takes_torch_reshape_of_the_attention_output():
    """MAnet's PAB reshapes the (n, hw, c) attention output straight to
    (n, c, h, w), which scrambles channels and positions. The block equals
    the Flax block on a non-square map, and differs from the unscrambled
    reading (the output as NHWC tokens), which the test computes from the
    same convs."""
    from rtseg_tpu.models.smp import PABlock as FlaxPAB
    c, h, w = 8, 3, 5
    block = PABlock(c, pab_channels=4)
    v = random_jax_variables(block, seed=3)
    load_jax_variables(block, v)
    x = np.random.RandomState(0).randn(2, h, w, c).astype(np.float32)
    want = np.asarray(FlaxPAB(pab_channels=4).apply(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = block(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        # the unscrambled reading: tokens (n, hw, c) back to NHWC
        flat = lambda y: y.permute(0, 2, 3, 1).reshape(2, h * w, -1)
        att = torch.softmax(torch.bmm(flat(block.center(xt)),
                                      flat(block.top(xt)).transpose(1, 2))
                            .reshape(2, -1), -1).reshape(2, h * w, h * w)
        tokens = torch.bmm(att, flat(block.bottom(xt)))
        plain = block.out(xt + tokens.reshape(2, h, w, c).permute(0, 3, 1, 2))
    assert not np.allclose(plain.permute(0, 2, 3, 1).numpy(), want,
                           atol=1e-3)


@pytest.mark.parametrize('encoder', ['resnet18', 'resnet50'])
def test_uniform_dilation_differs_from_the_surgical_one(encoder):
    """smp's dilation (output stride 8 for DeepLabV3) gives every block of
    a dilated stage stride 1 and the stage's rate, both 3x3s of a
    BasicBlock included; models/backbone.py's ResNet (ICNet's surgery)
    dilates only the first 3x3 of a stage. Same weights, same strides,
    other features."""
    enc = Encoder(encoder, (1, 1, 2, 4))
    stage4 = [m for n, m in enc.named_modules()
              if n.startswith('layer4_') and n.count('.') == 1
              and n.endswith(('conv1', 'conv2'))]
    dil = {n: m.conv.dilation for n, m in enc.named_modules()
           if n.startswith(('layer3_', 'layer4_')) and n.endswith('conv2')}
    assert set(dil.values()) <= {(2, 2), (4, 4)} and len(dil) >= 4
    assert all(m.conv.stride == (1, 1) for m in stage4)
    if encoder == 'resnet18':
        assert enc.layer3_1.conv1.conv.dilation == (2, 2)
        assert enc.layer4_1.conv1.conv.dilation == (4, 4)
    surgical = ResNet(encoder, dilations=(1, 1, 2, 4))
    sd = {k: v for k, v in enc.state_dict().items()}
    surgical.load_state_dict(sd, strict=True)
    x = torch.from_numpy(images(64, 1)).permute(0, 3, 1, 2)
    with torch.no_grad():
        a = enc.eval()(x)[-1]
        b = surgical.eval()(x)[-1]
    assert a.shape == b.shape == (1, enc.layer4_0.bn2.bn.num_features
                                  if encoder == 'resnet18'
                                  else 2048, 8, 8)
    assert not torch.allclose(a, b, atol=1e-3)


def test_uniform_dilation_matches_the_flax_encoder():
    """The smp encoder at output stride 8 and 16 (ResNet-18, MobileNetV2)
    gives the Flax encoder's five features."""
    from rtseg_tpu.models.smp import Encoder as FlaxEncoder
    x = images(64, 1)
    for name, dil in (('resnet18', (1, 1, 2, 4)), ('resnet18', (1, 1, 1, 2)),
                      ('mobilenet_v2', (1, 1, 2, 4))):
        enc = Encoder(name, dil)
        v = random_jax_variables(enc, seed=4)
        load_jax_variables(enc, v)
        fenc = FlaxEncoder(name, dil)
        want = jax.jit(lambda v, x: fenc.apply(v, x, False))(
            jax.tree.map(jnp.asarray, v), jnp.asarray(x))
        with torch.no_grad():
            got = enc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert len(got) == len(want) == 5
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w_), atol=1e-4, rtol=1e-4)


def test_pspnet_eval_encoder_stops_after_layer2():
    """Out of training PSPNet's encoder runs the stem, layer1 and layer2
    only (the decoder reads the stride-8 feature); in training all four
    stages run, so that their BatchNorm statistics move as in the JAX
    step."""
    from rtseg_tpu_torch.nn import DropoutMasks, bind_dropout
    model = build_smp_model('resnet18', 'pspnet', NC)
    masks = DropoutMasks(torch.Generator().manual_seed(0))
    ran = []
    for name in ('layer2_1', 'layer3_0', 'layer4_1'):
        getattr(model.encoder, name).register_forward_hook(
            lambda m, a, o, name=name: ran.append(name))
    x = torch.from_numpy(images(64))
    with torch.no_grad():
        model.eval()(x)
        assert ran == ['layer2_1']
        ran.clear()
        before = model.encoder.layer4_1.bn2.bn.running_mean.clone()
        with bind_dropout(model, masks):
            model.train()(x)
    assert ran == ['layer2_1', 'layer3_0', 'layer4_1']
    assert not torch.equal(before, model.encoder.layer4_1.bn2.bn.running_mean)
