"""PyTorch port against the JAX package: the smp hub's training forward.

One training forward of each decoder on ResNet-18 (and, through
tests/test_torch_mit.py, of MiT-b0 with FPN) from the same seeded
variables, with the same dropout and drop-path masks
in both packages (tests/test_torch_smp_models.py `smp_masks`): the logits
and the updated batch_stats near the Flax model run in float64
(`test_torch_backbone.assert_near_float64`: within 1e-4, or no farther
than the Flax model's own float32 run, made only where needed). PAN runs
at 128x128 (its pool ladder), the others at 64x64, 4 samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.nn import bind_dropout, dropout_modules
from rtseg_tpu_torch.models.smp import SMP_DECODERS
from rtseg_tpu_torch.utils.convert import _flatten, to_jax_variables
from test_torch_backbone import assert_near_float64
from test_torch_smp_models import (flax_model, images, port_model, side,
                                   smp_masks, variables)

# MiT-b0 with FPN, with its drop paths, is in tests/test_torch_mit.py
TRAIN_PAIRS = [('resnet18', d) for d in SMP_DECODERS]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_train_forward(fmodel, v, x, dtype):
    """(logits, batch_stats) of one training forward of the Flax model in
    `dtype` (the drop path asks for a 'dropout' rng before its masks are
    given)."""
    with jax.enable_x64(dtype == jnp.float64):
        o, mut = jax.jit(lambda v, x: fmodel.apply(
            v, x, True, mutable=['batch_stats'],
            rngs={'dropout': jax.random.PRNGKey(0)}))(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), v),
            jnp.asarray(x, dtype))
        return jax.device_get((o, mut.get('batch_stats', {})))


@pytest.mark.parametrize('encoder,decoder', TRAIN_PAIRS)
def test_training_forward_and_batch_stats_match_flax(encoder, decoder):
    """`assert_near_float64` on the logits and every batch_stats leaf; the
    Flax model's own float32 run, which that check reads only where the
    port lies farther than 1e-4 from the float64 run, is made only then."""
    x = images(side(encoder, decoder), n=4, seed=7)
    model = port_model(encoder, decoder).train()
    drops = dropout_modules(model)
    fmodel, v = flax_model(encoder, decoder), variables(encoder, decoder)
    with smp_masks(3) as source:
        out64, bs64 = flax_train_forward(fmodel, v, x, jnp.float64)
        with torch.no_grad(), bind_dropout(model, source, drops):
            got = model(torch.from_numpy(x))
        got_bs = dict(_flatten(to_jax_variables(model).get('batch_stats',
                                                           {})))
        bs64 = dict(_flatten(bs64))
        pairs = [('logits', got.numpy(), out64)] + [
            ('/'.join(k), got_bs[k], bs64[k]) for k in bs64]
        assert got_bs.keys() == bs64.keys()
        far = [p for p in pairs if not np.allclose(p[1], p[2], atol=1e-4,
                                                   rtol=1e-4)]
        if far:
            out32, bs32 = flax_train_forward(fmodel, v, x, jnp.float32)
            bs32 = dict(_flatten(bs32))
            want32 = {'logits': out32, **{'/'.join(k): bs32[k]
                                          for k in bs32}}
            for what, g, w64 in far:
                assert_near_float64(g, w64, want32[what], what)
    # ASPP's Dropout, FPN's and PSPNet's Dropout2d, MiT's drop paths
    assert bool(drops) == (decoder in ('deeplabv3', 'deeplabv3p', 'fpn',
                                       'pspnet') or encoder != 'resnet18')
