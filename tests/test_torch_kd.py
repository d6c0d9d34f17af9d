"""PyTorch port against the JAX package: knowledge distillation, and the
refusal messages that name ROADMAP.md items.

* `kd_loss` against the JAX package's for 'kl_div' and 'mse', on random
  logits and on a teacher whose probabilities are near one-hot (the clip
  at 1e-12 of its log), in float32 and on bf16 logits.
* The KD train step against the JAX build_train_step with the frozen
  teacher (MobileNetV2 FPN, as tests/test_kd_smp.py) and an smp ResNet-18
  Unet student, float32, 2 steps at a peak LR of 1e-3 from the same
  weights: loss and loss_kd within 1e-5 relative each step; params,
  batch_stats and their EMA within 1e-4.
* The KD term beside the aux heads and the detail head.
* The trainer's teacher: loaded from a checkpoint of the port, frozen (no
  gradient, eval mode, outside the optimizer, the EMA and the
  checkpoints), unchanged by a run; no checkpoint raises.
* `backbone_ckpt` into the smp hub's `encoder` scope (ResNet-18 and
  MobileNetV2) equal to the JAX package's import.
* Each refusal that names a ROADMAP.md item names it by a title that
  ROADMAP.md's Queue 1 has.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.losses import get_kd_loss_fn, kd_loss
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.models.smp import build_smp_model
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.train.checkpoint import save_best_ckpt
from rtseg_tpu_torch.train.state import TrainState
from rtseg_tpu_torch.train.step import _make_forward_loss
from rtseg_tpu_torch.utils.convert import (_flatten, flax_init_variables,
                                           load_jax_variables,
                                           random_jax_variables,
                                           to_jax_variables)
from test_torch_init_and_import import _jax_import, _torchvision_file
from test_torch_last_train import train_batches
from test_torch_resnet_train import (KW, PORT_ONLY, _mesh,
                                     assert_trees_close, jax_state)

ROOT = Path(__file__).resolve().parent.parent
TEACHER = dict(teacher_encoder='mobilenet_v2', teacher_decoder='fpn')
KD = dict(kd_training=True, kd_loss_type='kl_div', kd_temperature=4.0,
          kd_loss_coefficient=1.0, **TEACHER)
STUDENT = dict(model='smp', encoder='resnet18', decoder='unet')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits(seed, scale=1.0, shape=(2, 5, 7, 19)):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize('kd_type', ['kl_div', 'mse'])
@pytest.mark.parametrize('teacher_scale', [1.0, 60.0])
def test_kd_loss_equals_jax(kd_type, teacher_scale):
    """teacher_scale 60: softmax(t / 4) near one-hot, most probabilities
    below 1e-12 before the clip."""
    from rtseg_tpu.losses import kd_loss as jax_kd_loss
    s, t = _logits(0), _logits(1, teacher_scale)
    for dtype in (np.float32, jnp.bfloat16):
        js, jt = jnp.asarray(s, dtype), jnp.asarray(t, dtype)
        want = float(jax_kd_loss(js, jt, kd_type, 4.0))
        ts, tt = (torch.from_numpy(np.array(a, np.float32))
                  for a in (js, jt))
        if dtype != np.float32:
            ts, tt = ts.to(torch.bfloat16), tt.to(torch.bfloat16)
        got = kd_loss(ts, tt, kd_type, 4.0)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-9)
    if teacher_scale > 1.0 and kd_type == 'kl_div':
        p = torch.softmax(torch.from_numpy(t) / 4.0, -1)
        assert float((p < 1e-12).float().mean()) > 0.3


def test_kd_loss_fn_reads_the_config():
    cfg = SegConfig(kd_loss_type='mse', kd_temperature=2.0)
    s, t = torch.from_numpy(_logits(2)), torch.from_numpy(_logits(3))
    assert float(get_kd_loss_fn(cfg)(s, t)) == float(kd_loss(s, t, 'mse'))
    cfg = SegConfig(kd_loss_type='kl_div', kd_temperature=2.0)
    assert float(get_kd_loss_fn(cfg)(s, t)) == float(kd_loss(s, t, 'kl_div',
                                                            2.0))


def _teacher_ckpt(path, variables):
    """A best.ckpt of the port holding the teacher `variables`."""
    teacher = build_smp_model(TEACHER['teacher_encoder'],
                              TEACHER['teacher_decoder'], KW['num_class'])
    load_jax_variables(teacher, variables)
    save_best_ckpt(str(path), TrainState(0, teacher, None, teacher), 1, 0.0)
    return str(path)


def _teacher_variables(seed=21):
    return random_jax_variables(build_smp_model(
        TEACHER['teacher_encoder'], TEACHER['teacher_decoder'],
        KW['num_class']), seed=seed)


def test_kd_train_steps_match_jax(tmp_path):
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.models import get_teacher_model as jax_teacher
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.step import build_train_step as jax_train_step
    n, samples = 2, 4
    kw = dict(KW, **STUDENT, **KD, train_bs=samples,
              synthetic_len=3 * samples)
    tv = _teacher_variables()
    ckpt = _teacher_ckpt(tmp_path / 'teacher.ckpt', tv)
    jcfg = JaxSegConfig(**kw, teacher_ckpt=ckpt)
    jcfg.resolve(num_devices=1)
    jcfg.resolve_schedule(train_num=kw['synthetic_len'])
    opt = get_optimizer(jcfg)
    step = jax_train_step(jcfg, jax_get_model(jcfg), opt, _mesh(),
                          jax_teacher(jcfg), jax.tree.map(jnp.asarray, tv))
    v = random_jax_variables(get_model(SegConfig(**kw)), seed=22)
    state = jax_state(v, opt)
    data = train_batches('smp', n, samples)
    jm = []
    for imgs, msks in data:
        state, m = step(state, jnp.asarray(imgs), jnp.asarray(msks))
        jm.append({k: float(x) for k, x in m.items()})
    trainer = SegTrainer(SegConfig(**kw, **PORT_ONLY, teacher_ckpt=ckpt,
                                   save_dir=str(tmp_path / 'run')),
                         device='cpu', variables=v)
    tm = []
    for imgs, msks in data:
        trainer.state, m = trainer.train_step(
            trainer.state, torch.from_numpy(imgs), torch.from_numpy(msks))
        tm.append({k: float(x) for k, x in m.items()})
    assert [set(m) for m in tm] == [set(m) for m in jm] == \
        [{'loss', 'loss_kd'}] * n
    for got, want in zip(tm, jm):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    want = jax.device_get(
        {'variables': {'params': state.params,
                       'batch_stats': state.batch_stats},
         'ema': {'params': state.ema_params,
                 'batch_stats': state.ema_batch_stats}})
    assert_trees_close(to_jax_variables(trainer.model), want['variables'],
                       1e-4, 'params/batch_stats')
    assert_trees_close(to_jax_variables(trainer.ema_model), want['ema'],
                       1e-4, 'ema')


@pytest.mark.parametrize('model,extra', [
    ('ddrnet', dict(use_aux=True)), ('stdc', dict(use_detail_head=True)),
    ('fastscnn', {})])
def test_kd_term_beside_aux_and_detail_heads(model, extra):
    """The KD term is added to the loss of every branch, on the main
    logits: loss = the branch's loss + coefficient * kd_loss."""
    from rtseg_tpu_torch.nn import DropoutMasks, bind_dropout
    kw = dict(num_class=KW['num_class'], model=model, **extra, **TEACHER)
    teacher = build_smp_model(TEACHER['teacher_encoder'],
                              TEACHER['teacher_decoder'], KW['num_class'])
    load_jax_variables(teacher, _teacher_variables())
    teacher.eval()
    student = get_model(SegConfig(**kw))
    load_jax_variables(student, random_jax_variables(student, seed=4))
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    masks = torch.from_numpy(np.random.RandomState(1).randint(
        0, KW['num_class'], (2, 64, 64)).astype(np.int64))
    losses = {}
    for coef in (0.0, 0.5):
        cfg = SegConfig(**kw, kd_training=True, kd_loss_coefficient=coef,
                        compute_dtype='float32')
        fresh = get_model(SegConfig(**kw))
        fresh.load_state_dict(student.state_dict())
        fresh.train()
        with bind_dropout(fresh, DropoutMasks(torch.Generator())):
            loss, metrics = _make_forward_loss(cfg, teacher)(fresh, x, masks)
        losses[coef] = (float(loss.detach()), float(metrics['loss_kd']))
        assert ('loss_detail' in metrics) == ('use_detail_head' in extra)
    (base, kd0), (total, kd1) = losses[0.0], losses[0.5]
    assert kd0 == kd1 > 0
    assert total == pytest.approx(base + 0.5 * kd1, rel=1e-6)
    with pytest.raises(ValueError, match='teacher'):
        _make_forward_loss(SegConfig(**kw, kd_training=True))


def test_trainer_loads_a_frozen_teacher_that_a_run_leaves_unchanged(
        tmp_path):
    tv = _teacher_variables()
    ckpt = _teacher_ckpt(tmp_path / 'teacher.ckpt', tv)
    kw = dict(KW, **STUDENT, **KD, **PORT_ONLY, train_bs=4, val_bs=4,
              synthetic_len=8, total_epoch=1,
              save_dir=str(tmp_path / 'run'))
    trainer = SegTrainer(SegConfig(**kw, teacher_ckpt=ckpt), device='cpu')
    teacher = trainer.teacher
    assert_trees_close(to_jax_variables(teacher), tv, 0.0, 'teacher')
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    opt = {id(p) for g in trainer.state.optimizer.param_groups
           for p in g['params']}
    assert not opt & {id(p) for p in teacher.parameters()}
    score = trainer.run()
    assert np.isfinite(score) and len(trainer.epoch_kd_losses) == 1
    assert np.isfinite(trainer.epoch_kd_losses[0])
    assert_trees_close(to_jax_variables(teacher), tv, 0.0, 'teacher')
    own = set(_flatten(to_jax_variables(trainer.model)))
    assert own == set(_flatten(to_jax_variables(trainer.ema_model)))
    payload = torch.load(tmp_path / 'run' / 'last.ckpt' / 'state.pt',
                         weights_only=True)
    for key in ('variables', 'ema_variables'):
        assert set(_flatten(payload[key])) == own
    with pytest.raises(ValueError, match='teacher_ckpt'):
        SegTrainer(SegConfig(**kw), device='cpu')


@pytest.mark.parametrize('encoder', ['resnet18', 'mobilenet_v2'])
def test_backbone_import_into_the_encoder_scope_equals_jax(tmp_path,
                                                           encoder):
    """A torchvision-named state_dict through `backbone_ckpt` into the smp
    model's `encoder` scope equals the JAX package's load_torch_backbone
    over the same starting weights; MobileNetV2's 1280-channel `head`,
    which torchvision's features hold as features.18, keeps its init in
    both."""
    path = _torchvision_file(tmp_path, encoder)
    cfg = SegConfig(**dict(KW, **PORT_ONLY, model='smp', encoder=encoder,
                           decoder='fpn', backbone_ckpt=path,
                           backbone_type=encoder,
                           save_dir=str(tmp_path / 'run')))
    trainer = SegTrainer(cfg, device='cpu')
    want = _jax_import(cfg, path, 'encoder')
    start = dict(_flatten(flax_init_variables(get_model(cfg),
                                              cfg.random_seed)))
    for m in (trainer.model, trainer.ema_model):
        got = dict(_flatten(to_jax_variables(m)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], '/'.join(k))
        moved = {k for k in want if not np.array_equal(got[k], start[k])}
        assert moved and all(k[1] == 'encoder' for k in moved)
        kept = {k for k in want if k[1] == 'encoder'} - moved
        assert all(k[2] in ('head', 'head_bn') for k in kept), sorted(kept)


def _message(fn):
    with pytest.raises((NotImplementedError, FileNotFoundError)) as e:
        fn()
    return str(e.value)


def test_refusals_name_roadmap_items_by_titles_it_has(tmp_path):
    """The refusals that send the reader to ROADMAP.md name the Queue 1
    item by its title (a renumbering cannot make them stale), and each
    title is an item of ROADMAP.md's Queue 1. What "Trainer, checkpoint
    and data" refused works since: a Custom set and a test folder of
    JPEGs load, a JPEG body cut short raises ValueError as PIL does, and
    an orbax directory's refusal names the bridge that converts it."""
    import io
    from PIL import Image
    from rtseg_tpu_torch.data import get_loader
    from rtseg_tpu_torch.train.checkpoint import restore_weights
    from rtseg_tpu_torch.data.custom import Custom
    from torch_data_trees import custom_tree
    (tmp_path / 'orbax').mkdir()
    (tmp_path / 'orbax' / 'meta.json').write_text('{}')
    orbax = _message(lambda: restore_weights(str(tmp_path / 'orbax'),
                                             torch.nn.Linear(1, 1)))
    assert 'tools/orbax_to_torch.py' in orbax \
        and 'ROADMAP.md Queue 1' not in orbax, orbax
    # a Custom set with a JPEG in both splits
    jpeg_tree = custom_tree(tmp_path / 'custom', n_train=1, n_val=1)
    from rtseg_tpu_torch.data import png
    for split in ('train', 'val'):
        buf = io.BytesIO()
        Image.fromarray(np.full((40, 50, 3), 90, np.uint8)).save(buf,
                                                                  'JPEG')
        (tmp_path / 'custom' / split / 'imgs' / '1.jpg').write_bytes(
            buf.getvalue())
        (tmp_path / 'custom' / split / 'masks' / '1.png').write_bytes(
            png.encode(np.zeros((40, 50), np.uint8)))
    cfg = SegConfig(dataset='custom', data_root=jpeg_tree, train_bs=1)
    train, val = get_loader(cfg)
    assert len(train.dataset) == len(val.dataset) == 2
    assert Custom(SegConfig(dataset='custom', data_root=jpeg_tree),
                  'val').images[-1].endswith('1.jpg')
    messages = []
    messages.append(_message(lambda: SegTrainer(
        SegConfig(spatial_partition=2), device='cpu')))
    # is_testing is ported: the trainer builds for prediction alone
    from rtseg_tpu_torch.serve import ServeEngine, make_preprocess
    (tmp_path / 'test_imgs').mkdir()
    (tmp_path / 'test_imgs' / 'a.png').write_bytes(
        png.encode(np.zeros((16, 24, 3), np.uint8)))
    t = SegTrainer(SegConfig(is_testing=True, model='fastscnn', num_class=3,
                             test_data_folder=str(tmp_path / 'test_imgs'),
                             save_dir=str(tmp_path / 'predict')),
                   device='cpu')
    assert len(t.test_set) == 1 and not t.predict_model.training
    assert not hasattr(t, 'train_loader')
    # and on a folder with a JPEG
    t = SegTrainer(SegConfig(is_testing=True, model='fastscnn', num_class=3,
                             test_data_folder=str(tmp_path / 'custom' /
                                                  'val' / 'imgs'),
                             load_ckpt=False,
                             save_dir=str(tmp_path / 'predict')),
                   device='cpu')
    assert t.test_set.img_names == ['0.png', '1.jpg']
    # the serving slice's refusals; a JPEG body cut short raises as PIL
    with pytest.raises(ValueError, match='truncated'):
        make_preprocess(SegConfig())(b'\xff\xd8\xff')
    messages.append(_message(lambda: ServeEngine(
        lambda x: x, [(8, 8)], 1, device='cpu', compile_workers=2)))
    roadmap = (ROOT / 'ROADMAP.md').read_text()
    queue1 = roadmap[roadmap.index('### Queue 1'):
                     roadmap.index('### Queue 2')]
    titles = set()
    for text in messages:
        found = re.findall(r'ROADMAP\.md Queue 1, "([^"]+)"', text)
        assert len(found) == 1, text
        titles.add(found[0])
    assert titles == {'The planes', 'Spatial mesh'}
    for title in titles:
        assert re.search(r'^\d+\. (~~)?\*\*' + re.escape(title), queue1,
                         re.M), title
