"""The port's Cityscapes and Custom datasets (rtseg_tpu_torch/data/
{protocol,cityscapes,custom}.py) against the JAX package's, on PNG trees
the tests write: the same files in the same order, and `get(i, rng)`,
`prepare` and `augment_raw` bit-equal with the same rng; the data.yaml
reader against yaml.safe_load; a Custom set takes every file in imgs/,
as the JAX package does, and a truncated JPEG among them raises when it
is read."""

import os

import numpy as np
import pytest
import yaml

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.data.cityscapes import Cityscapes as JaxCityscapes
from rtseg_tpu.data.cityscapes import ID_TO_TRAIN_ID as JAX_TABLE
from rtseg_tpu.data.custom import Custom as JaxCustom
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data.cityscapes import ID_TO_TRAIN_ID, Cityscapes
from rtseg_tpu_torch.data.custom import Custom, read_data_yaml
from torch_data_trees import cityscapes_tree, custom_tree

AUG = dict(randscale=(-0.5, 1.0), h_flip=0.5, crop_size=32)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp('sets')
    return {'cityscapes': cityscapes_tree(base / 'cityscapes'),
            'custom': custom_tree(base / 'custom')}


def _pair(kind, root, mode, **kw):
    base = dict(dataset=kind, data_root=root, **kw)
    if kind == 'custom':
        base.update(train_size=48, test_size=40)
    cfg = SegConfig(**base).resolve()
    jcfg = JaxSegConfig(**base).resolve()
    if kind == 'cityscapes':
        return Cityscapes(cfg, mode), JaxCityscapes(jcfg, mode)
    return Custom(cfg, mode), JaxCustom(jcfg, mode)


def test_label_table_is_the_jax_packages():
    np.testing.assert_array_equal(ID_TO_TRAIN_ID, JAX_TABLE)


@pytest.mark.parametrize('kind', ['cityscapes', 'custom'])
@pytest.mark.parametrize('mode', ['train', 'val'])
@pytest.mark.parametrize('jitter', [0.0, 0.5])
def test_samples_equal_the_jax_packages(trees, kind, mode, jitter):
    ours, theirs = _pair(kind, trees[kind], mode, brightness=jitter,
                         contrast=jitter, saturation=jitter, **AUG)
    assert ours.images == theirs.images and ours.masks == theirs.masks
    assert len(ours) == len(theirs) > 0
    assert ours.supports_raw_tail == theirs.supports_raw_tail
    assert ours.cache_spec() == theirs.cache_spec()
    for i in range(len(ours)):
        for a, b in zip(ours.prepare(i), theirs.prepare(i)):
            np.testing.assert_array_equal(a, b)
        for seed in (0, 1):
            got = ours.get(i, np.random.default_rng((seed, i)))
            want = theirs.get(i, np.random.default_rng((seed, i)))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            if ours.supports_raw_tail:
                head = ours.prepare(i)
                got = ours.augment_raw(*head, np.random.default_rng(seed))
                want = theirs.augment_raw(*head, np.random.default_rng(seed))
                for a, b in zip(got[:2], want[:2]):
                    np.testing.assert_array_equal(a, b)
                assert got[2] == want[2]


YAMLS = [
    'path: /data/x\nnames:\n  0: bg\n  1: road\n',
    "path: '/data/with space'   # a comment\nnames: {0: bg, 1: 'a b', 2: c}\n",
    '# header\n\npath: "/d"\nnc: 2\nnames:\n    0: bg  # trailing\n    1: fg\n',
    '---\nnames:\n  0: x\npath: /p\n',
]


@pytest.mark.parametrize('text', YAMLS)
def test_data_yaml_reader_equals_safe_load(text):
    want = yaml.safe_load(text)
    got = read_data_yaml(text)
    assert got['path'] == want['path']
    assert got['names'] == want['names']


@pytest.mark.parametrize('text', [
    'path: /p\nnames:\n  - a\n  - b\n',
    'path: /p\nnames: [a, b]\n',
    'path: &a /p\n',
    'path: /p\nnames:\n  0:\n    nested: 1\n',
    'path: /p\npath: /q\n',
    'path:\n  - /p\n',
])
def test_data_yaml_reader_raises_on_other_constructs(text):
    with pytest.raises(ValueError, match='data.yaml'):
        read_data_yaml(text)


def test_custom_jpeg_raises_the_refusal(tmp_path):
    """A JPEG in imgs/ is an image of the set (JPEGs are decoded since
    the port has a JPEG decoder); one cut short raises ValueError when it
    is read, as PIL raises without LOAD_TRUNCATED_IMAGES."""
    root = custom_tree(tmp_path / 'custom', n_train=2, n_val=1)
    (tmp_path / 'custom' / 'train' / 'imgs' / '9.jpg').write_bytes(
        b'\xff\xd8\xff\xe0' + bytes(16))
    cfg = SegConfig(dataset='custom', data_root=root).resolve()
    ds = Custom(cfg, 'train')
    assert [os.path.basename(p) for p in ds.images] == ['0.png', '1.png',
                                                        '9.jpg']
    assert ds.masks[2].endswith(os.path.join('masks', '9.png'))
    with pytest.raises(ValueError, match='truncated|corrupt'):
        ds.prepare(2)
    Custom(cfg, 'val')                   # the val split has no JPEG
