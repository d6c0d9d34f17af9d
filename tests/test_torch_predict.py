"""Prediction of the port (`main_torch.main([... '--is_testing' ...])`,
SegTrainer.predict) against the JAX package's SegTrainer.predict, on the
same folder of 3 PNGs at 2 shapes, test_bs 2, FastSCNN with 5 classes in
float32 at scale 0.5 (so the blend's NEAREST resize to the raw image
runs), from the same weights: the JAX trainer's own PRNGKey(0) init,
which the port reads from a checkpoint of its own made from that tree.

Tolerance: the decoded mask PNGs equal the JAX files at every pixel whose
top-2 gap in the JAX float32 logits is at least 1e-4; the blend PNGs at
every raw pixel whose NEAREST source pixel is such a pixel. Also: a
missing checkpoint raises FileNotFoundError, a JPEG in the folder is
predicted like a PNG (its mask file named after it, with .png) while a
GIF raises NotImplementedError, and the trainer builds for prediction
alone (no loaders, no optimizer)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import main_torch
from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.data.test_folder import TestFolder as JaxTestFolder
from rtseg_tpu.models import get_model as jax_get_model
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import png
from rtseg_tpu_torch.data.transforms import resize_nearest_pil
from rtseg_tpu_torch.models.registry import get_model
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.train.checkpoint import save_best_ckpt
from rtseg_tpu_torch.train.state import TrainState
from rtseg_tpu_torch.utils.convert import load_jax_variables

GAP = 1e-4
SCALE = 0.5
SHAPES = [(64, 96), (96, 128), (64, 96)]
KW = dict(model='fastscnn', num_class=5, colormap='custom',
          compute_dtype='float32', test_bs=2, scale=SCALE)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_folder(folder, shapes, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for i, (h, w) in enumerate(shapes):
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        with open(os.path.join(folder, f'img{i}.png'), 'wb') as f:
            f.write(png.encode(image, (0, 1, 2, 3, 4)))
    return folder


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The JAX predict and the port's, on one folder; their save dirs and
    the JAX logits of each image."""
    from rtseg_tpu.parallel import make_mesh
    from rtseg_tpu.train import trainer as jax_trainer_mod
    root = tmp_path_factory.mktemp('predict')
    folder = _write_folder(str(root / 'imgs'), SHAPES)
    jcfg = JaxSegConfig(is_testing=True, test_data_folder=folder,
                        save_dir=str(root / 'jax'), use_tb=False,
                        use_obs=False, **KW)
    real_mesh = jax_trainer_mod.make_mesh
    jax_trainer_mod.make_mesh = lambda **kw: make_mesh(num_devices=1, **kw)
    try:
        jtrainer = jax_trainer_mod.SegTrainer(jcfg)
    finally:
        jax_trainer_mod.make_mesh = real_mesh
    jtrainer.predict()
    variables = jax.device_get(jtrainer.predict_vars)

    # the port's checkpoint of the JAX trainer's init tree
    model = get_model(SegConfig(**KW))
    load_jax_variables(model, variables)
    ckpt = str(root / 'ckpt' / 'best.ckpt')
    save_best_ckpt(ckpt, TrainState(0, model, None, model), 1, 0.0)
    save = str(root / 'port')
    trainer, score = main_torch.main([
        '--device', 'cpu', '--is_testing', '--test_data_folder', folder,
        '--load_ckpt_path', ckpt, '--save_dir', save, '--model', 'fastscnn',
        '--num_class', '5', '--colormap', 'custom', '--compute_dtype',
        'float32', '--test_bs', '2', '--scale', str(SCALE)])

    jmodel = jax_get_model(jcfg)
    apply = jax.jit(lambda x: jmodel.apply(variables, x, False))
    folder_set = JaxTestFolder(jcfg)
    logits = {}
    for i in range(len(folder_set)):
        raw, aug, name = folder_set.get(i)
        logits[name] = (raw, np.asarray(apply(jnp.asarray(aug[None])))[0])
    return trainer, score, str(root / 'jax'), save, logits


def _decided(logits):
    top2 = np.sort(logits.astype(np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] >= GAP


def test_main_predicts_and_returns_no_score(run):
    trainer, score, _, save, _ = run
    assert score is None and trainer.config.is_testing
    assert not hasattr(trainer, 'train_loader')
    stats = trainer.predict_stats
    assert stats['executables'] == 2                   # two exact shapes
    assert stats['batch'] == 2 and stats['retraces'] == 0
    # at least a batch a shape, each padded to test_bs
    assert stats['images'] == 2 * sum(stats['calls'].values()) >= 4
    assert sorted(os.listdir(os.path.join(save, 'predicts'))) == \
        ['img0.png', 'img1.png', 'img2.png']


def test_masks_equal_jax_where_the_logits_decide(run):
    _, _, jdir, save, logits = run
    for name, (raw, lg) in logits.items():
        ours = png.read(os.path.join(save, 'predicts', name), 'RGB')
        theirs = np.asarray(Image.open(os.path.join(jdir, 'predicts',
                                                    name)).convert('RGB'))
        assert ours.shape == theirs.shape == lg.shape[:2] + (3,)
        decided = _decided(lg)
        assert decided.mean() > 0.95           # the check has pixels
        assert np.array_equal(ours[decided], theirs[decided])


def test_blends_equal_jax_where_the_logits_decide(run):
    _, _, jdir, save, logits = run
    for name, (raw, lg) in logits.items():
        ours = png.read(os.path.join(save, 'predicts_blend', name), 'RGB')
        theirs = np.asarray(Image.open(os.path.join(
            jdir, 'predicts_blend', name)).convert('RGB'))
        assert ours.shape == theirs.shape == raw.shape
        h, w = raw.shape[:2]
        decided = resize_nearest_pil(_decided(lg).astype(np.uint8), w,
                                     h).astype(bool)
        assert np.array_equal(ours[decided], theirs[decided])


def test_a_missing_checkpoint_raises(tmp_path):
    folder = _write_folder(str(tmp_path / 'imgs'), SHAPES[:1])
    cfg = SegConfig(is_testing=True, test_data_folder=folder,
                    load_ckpt_path=str(tmp_path / 'none'),
                    save_dir=str(tmp_path / 's'), **KW)
    with pytest.raises(FileNotFoundError, match='Could not find any'):
        SegTrainer(cfg, device='cpu')


def test_a_jpeg_in_the_folder_raises(tmp_path):
    """Since the JPEG decoder: a JPEG is predicted like the PNGs (mask and
    blend written under its base name); a GIF, which the port does not
    decode, raises when the folder is opened."""
    folder = _write_folder(str(tmp_path / 'imgs'), SHAPES[:1])
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (40, 56, 3), dtype=np.uint8)).save(
        os.path.join(folder, 'photo.jpg'), quality=85)
    argv = ['--device', 'cpu', '--is_testing', '--test_data_folder',
            folder, '--save_dir', str(tmp_path / 's'), '--model',
            'fastscnn', '--num_class', '5', '--compute_dtype', 'float32',
            '--load_ckpt', 'false']
    trainer, score = main_torch.main(argv)
    assert score is None
    for sub in ('predicts', 'predicts_blend'):
        got = png.read(str(tmp_path / 's' / sub / 'photo.png'), 'RGB')
        assert got.shape == (40, 56, 3)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        os.path.join(folder, 'anim.gif'))
    with pytest.raises(NotImplementedError,
                       match=r'anim\.gif is neither a PNG nor a JPEG'):
        main_torch.main(argv)
