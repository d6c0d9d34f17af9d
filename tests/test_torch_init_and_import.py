"""PyTorch port against the JAX package: the trainer's default weights,
`remat` (refused until it was ported), and the torchvision backbone
import.

* `flax_init_variables` against the Flax twin's `model.init` for
  FastSCNN, BiSeNetv2 and DABNet (PReLU slopes): the same tree, the same
  constants exactly (zero biases, BatchNorm scale 1, mean 0, var 1, PReLU
  0.25), and lecun-normal kernels (std * sqrt(fan_in) within sampling
  error of 1, every value within the truncation at 2 / 0.8796 standard
  deviations); `SegTrainer` without variables starts from it.
* `config.backbone_ckpt`: a torchvision-named ResNet-18 or MobileNetV2
  state_dict in a file, imported by `SegTrainer` into the model's
  `backbone` or `frontend` scope, equals leaf for leaf the JAX package's
  `load_torch_backbone` on the same file over the same starting weights
  (ICNet, SwiftNet, FarSeeNet, LinkNet, LiteSeg),
  in the model and in its EMA; everything else keeps the Flax init, and a
  resumed checkpoint still overrides the import. A model without a
  top-level backbone scope raises ValueError, as the JAX trainer does, and
  a backbone_type that does not fit raises as the JAX import raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import torchvision_state_dict
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.utils import convert
from rtseg_tpu_torch.utils.convert import (_flatten, flax_init_variables,
                                           to_jax_variables)
from test_torch_import import _torch_resnet18

H, W, NC = 64, 128, 19
TRUNC_STD = 0.87962566103423978
INIT_MODELS = ('fastscnn', 'bisenetv2', 'dabnet')
PORT_ONLY = dict(use_tb=False, use_obs=False, base_workers=0,
                 dataset='synthetic', crop_h=H, crop_w=W, train_bs=2,
                 val_bs=2, synthetic_len=4, compute_dtype='float32',
                 num_class=NC, use_aux=False, random_seed=5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, **kw):
    return SegConfig(**{**PORT_ONLY, 'save_dir': str(tmp_path), **kw})


def _kernel_checks(flat, what):
    """Each kernel: sqrt(mean(x^2) * fan_in) within 5 standard errors of 1
    (a unit-variance normal truncated at +-2 / 0.8796 has Var(x^2) = 1.366,
    so that error is sqrt(1.366 / n) / 2 for n values), and every |x| at
    most 2 / 0.8796 / sqrt(fan_in). Returns the pooled mean(x^2 * fan_in)."""
    num = den = 0.0
    for path, k in flat.items():
        if path[-1] != 'kernel':
            continue
        k = np.asarray(k, np.float64)
        fan_in = int(np.prod(k.shape[:-1]))
        m2 = float((k * k).mean()) * fan_in
        se = np.sqrt(1.366 / k.size) / 2
        assert abs(np.sqrt(m2) - 1) <= 5 * se, (what, path, m2, k.size)
        bound = 2 / TRUNC_STD / np.sqrt(fan_in)
        assert float(np.abs(k).max()) <= bound * (1 + 1e-6), (what, path)
        num += m2 * k.size
        den += k.size
    return num / den


@pytest.mark.parametrize('name', INIT_MODELS)
def test_flax_init_matches_the_flax_model_init(name):
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    kw = dict(model=name, num_class=NC, use_aux=False)
    got = flax_init_variables(get_model(SegConfig(**kw)), seed=0)
    want = jax.device_get(jax_get_model(JaxSegConfig(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    leaves = {k[-1] for k in got}
    assert {'kernel', 'bias', 'scale', 'mean', 'var'} <= leaves
    assert ('alpha' in leaves) == (name == 'dabnet')
    for k, v in got.items():
        assert v.dtype == np.float32
        if k[-1] != 'kernel':
            np.testing.assert_array_equal(v, want[k], err_msg='/'.join(k))
    pooled = {}
    for what, flat in (('port', got), ('flax', want)):
        pooled[what] = _kernel_checks(flat, what)
        assert abs(pooled[what] - 1) < 0.02, (what, pooled[what])


def test_flax_init_is_seeded_and_refuses_a_leaf_it_does_not_know(
        monkeypatch):
    model = get_model(SegConfig(model='dabnet', num_class=NC, use_aux=False))
    a, b, c = (dict(_flatten(flax_init_variables(model, s)))
               for s in (3, 3, 4))
    kernels = [k for k in a if k[-1] == 'kernel']
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not any(np.array_equal(a[k], c[k]) for k in kernels)
    monkeypatch.delitem(convert._FLAX_CONSTANTS, 'alpha')
    with pytest.raises(KeyError, match='prelu/alpha'):
        flax_init_variables(model, 3)


def test_trainer_without_variables_starts_from_the_flax_init(tmp_path):
    cfg = _cfg(tmp_path, model='fastscnn')
    trainer = SegTrainer(cfg, device='cpu')
    want = dict(_flatten(flax_init_variables(get_model(cfg),
                                             cfg.random_seed)))
    for model in (trainer.model, trainer.ema_model):
        got = dict(_flatten(to_jax_variables(model)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], '/'.join(k))


def test_remat_is_refused(tmp_path):
    """remat, once refused, is ported: run() trains with it, to the
    weights of a run without it (tests/test_torch_remat.py holds the step
    to the JAX package's)."""
    runs = []
    for remat in (True, False):
        trainer = SegTrainer(_cfg(tmp_path / str(remat), model='fastscnn',
                                  remat=remat, total_epoch=1),
                             device='cpu')
        trainer.run()
        assert trainer.state.step == 2
        runs.append(dict(_flatten(to_jax_variables(trainer.model))))
    for k, v in runs[0].items():
        np.testing.assert_array_equal(v, runs[1][k], '/'.join(k))


# ------------------------------------------------------------------ import

def _resnet18_file(tmp_path):
    """torchvision's ResNet-18 module layout with random weights and BN
    statistics (as tests/test_torch_import.py builds it), saved."""
    torch.manual_seed(0)
    tm = _torch_resnet18()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    path = tmp_path / 'resnet18.pth'
    torch.save(tm.state_dict(), path)
    return str(path)


def _torchvision_file(tmp_path, backbone_type, wrap=False):
    """A random state_dict under torchvision's names, the classifier
    included, saved bare or under a 'state_dict' key."""
    sd = torchvision_state_dict(backbone_type, seed=1)
    path = tmp_path / f'{backbone_type}_{wrap}.pth'
    torch.save({'state_dict': sd} if wrap else sd, path)
    return str(path)


def _jax_import(cfg, path, scope):
    """The JAX package's load_torch_backbone over the port's starting
    weights (the Flax init of cfg.random_seed), as a flat tree."""
    from rtseg_tpu.utils.torch_import import load_torch_backbone
    start = flax_init_variables(get_model(cfg), cfg.random_seed)
    p, b = load_torch_backbone(path, cfg.backbone_type,
                               start['params'][scope],
                               start['batch_stats'][scope])
    start['params'][scope] = jax.tree.map(np.asarray, p)
    start['batch_stats'][scope] = jax.tree.map(np.asarray, b)
    return dict(_flatten(start))


@pytest.mark.parametrize('model,backbone_type,scope,source', [
    ('swiftnet', 'resnet18', 'backbone', 'module'),
    ('icnet', 'resnet18', 'backbone', 'generated'),
    ('farseenet', 'resnet18', 'frontend', 'wrapped'),
    ('liteseg', 'mobilenet_v2', 'backbone', 'generated'),
    ('linknet', 'resnet18', 'backbone', 'wrapped'),
])
def test_backbone_import_equals_the_jax_import(tmp_path, model,
                                               backbone_type, scope, source):
    if source == 'module':
        path = _resnet18_file(tmp_path)
    else:
        path = _torchvision_file(tmp_path, backbone_type,
                                 wrap=source == 'wrapped')
    cfg = _cfg(tmp_path, model=model, backbone_ckpt=path,
               backbone_type=backbone_type)
    trainer = SegTrainer(cfg, device='cpu')
    want = _jax_import(cfg, path, scope)
    start = dict(_flatten(flax_init_variables(get_model(cfg),
                                              cfg.random_seed)))
    moved = 0
    for m in (trainer.model, trainer.ema_model):
        got = dict(_flatten(to_jax_variables(m)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], '/'.join(k))
            if k[1] == scope:
                moved += not np.array_equal(got[k], start[k])
            else:
                np.testing.assert_array_equal(got[k], start[k], '/'.join(k))
    n_scope = sum(k[1] == scope for k in want)
    assert moved == 2 * n_scope      # every backbone leaf was replaced


def test_a_resumed_checkpoint_overrides_the_import(tmp_path):
    cfg = _cfg(tmp_path, model='swiftnet', random_seed=8)
    first = SegTrainer(cfg, device='cpu')
    first.save_ckpt()
    first._ckpt_writer.join()     # the write runs on the writer thread
    path = _torchvision_file(tmp_path, 'resnet18')
    resumed = SegTrainer(_cfg(tmp_path, model='swiftnet', backbone_ckpt=path),
                         device='cpu')
    want = dict(_flatten(to_jax_variables(first.model)))
    got = dict(_flatten(to_jax_variables(resumed.model)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], '/'.join(k))


@pytest.mark.parametrize('model', ['fastscnn', 'bisenetv1', 'canet'])
def test_a_model_without_a_top_level_backbone_scope_raises(tmp_path, model):
    """FastSCNN has no backbone. BiSeNetv1's ResNet sits in its context
    path (`ContextPath_0/backbone`) and CANet's MobileNetV2 in its context
    branch (`ContextBranch_0/backbone`); the JAX trainer looks for the
    scope at the top level of the Flax tree only, so they raise too."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    tree = jax.eval_shape(lambda: jax_get_model(JaxSegConfig(
        model=model, num_class=NC, use_aux=False)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), False))['params']
    assert not {'backbone', 'frontend', 'encoder'} & set(tree)
    path = _torchvision_file(tmp_path, 'mobilenet_v2' if model == 'canet'
                             else 'resnet18')
    with pytest.raises(ValueError, match='no backbone scope'):
        SegTrainer(_cfg(tmp_path, model=model, backbone_ckpt=path),
                   device='cpu')


def test_a_backbone_type_that_does_not_fit_raises_as_in_jax(tmp_path):
    """ResNet-18 weights named onto LiteSeg's MobileNetV2 stop at the first
    leaf the backbone lacks, in the JAX import and in the port; the
    MobileNetV2 file with backbone_type resnet18 stops at its first
    missing name."""
    from rtseg_tpu.utils.torch_import import load_torch_backbone
    for model, file_type, declared in (('liteseg', 'resnet18', 'resnet18'),
                                       ('swiftnet', 'mobilenet_v2',
                                        'resnet18')):
        path = _torchvision_file(tmp_path, file_type)
        cfg = _cfg(tmp_path, model=model, backbone_ckpt=path,
                   backbone_type=declared)
        start = flax_init_variables(get_model(cfg), cfg.random_seed)
        with pytest.raises(KeyError) as jax_error:
            load_torch_backbone(path, declared, start['params']['backbone'],
                                start['batch_stats']['backbone'])
        with pytest.raises(KeyError) as port_error:
            SegTrainer(cfg, device='cpu')
        assert port_error.value.args == jax_error.value.args
