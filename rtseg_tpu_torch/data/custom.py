"""Custom dataset (counterpart of rtseg_tpu/data/custom.py).

Layout described by <data_root>/data.yaml:
    path: <root>
    names: {0: ..., 1: ...}
with images under <root>/<mode>/imgs and masks under <root>/<mode>/masks.
Square-resize via config.train_size / test_size, identity normalization.

The port reads data.yaml without PyYAML (`read_data_yaml`): `path` and
`names` (a block or flow mapping of int to str), other top-level keys
with plain scalar values (ignored), comments and blank lines. Any other
construct raises ValueError. As in the JAX package, every file in
imgs/ is an image (PNG or JPEG, data/image.py: another format raises
when it is read) and its mask is the PNG of the same base name in masks/.
"""

from __future__ import annotations

import os
import re
from typing import Dict

from .protocol import SegpipeFileDataset
from .transforms import EvalTransform, TrainTransform

_KEY = re.compile(r'([A-Za-z_][\w-]*)\s*:(?:\s+(.*))?$')
_ITEM = re.compile(r'(-?\d+)\s*:\s+(.+)$')


def _strip_comment(line: str) -> str:
    """The line without a ` #` comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str, where: str) -> str:
    """A plain, 'single' or "double" quoted scalar, as a string."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"' and '\\' not in text:
        return text[1:-1]
    if not text or text[0] in '\'"[]{}&*!|>%@`,-?' or ': ' in text \
            or text.endswith(':'):
        raise ValueError(f'data.yaml {where}: {text!r} is not a plain or '
                         f'quoted scalar')
    return text


def _names_flow(text: str, where: str) -> Dict[int, str]:
    body = text.strip()
    if not (body.startswith('{') and body.endswith('}')):
        raise ValueError(f'data.yaml {where}: names must be a mapping of '
                         f'int to str, got {text!r}')
    names = {}
    for part in filter(None, (p.strip() for p in body[1:-1].split(','))):
        m = _ITEM.match(part)
        if not m:
            raise ValueError(f'data.yaml {where}: {part!r} is not '
                             f'"<int>: <name>"')
        names[int(m.group(1))] = _scalar(m.group(2), where)
    return names


def read_data_yaml(text: str) -> dict:
    """`yaml.safe_load(text)` for the data.yaml files the Custom dataset
    reads; see the module docstring for what is taken."""
    out: dict = {}
    block = None                 # the key whose indented block is open
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f'line {lineno}'
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ('---', '...'):
            continue
        if '\t' in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f'data.yaml {where}: tab indentation')
        if line[0] in ' ':
            m = _ITEM.match(line.strip())
            if block != 'names' or not m:
                raise ValueError(f'data.yaml {where}: {raw.strip()!r} is '
                                 f'not an entry "<int>: <name>" of names')
            out['names'][int(m.group(1))] = _scalar(m.group(2), where)
            continue
        m = _KEY.match(line)
        if not m:
            raise ValueError(f'data.yaml {where}: {raw.strip()!r} is not '
                             f'"<key>: <value>"')
        key, value = m.group(1), (m.group(2) or '').strip()
        if key in out:
            raise ValueError(f'data.yaml {where}: {key!r} given twice')
        block = None
        if key == 'names':
            if value:
                out[key] = _names_flow(value, where)
            else:
                out[key], block = {}, key
        elif value:
            out[key] = _scalar(value, where)
        else:
            raise ValueError(f'data.yaml {where}: {key!r} has no value')
    return out


class Custom(SegpipeFileDataset):
    def __init__(self, config, mode: str = 'train'):
        data_root = os.path.expanduser(config.data_root)
        yaml_path = os.path.join(data_root, 'data.yaml')
        if not os.path.exists(yaml_path):
            raise FileNotFoundError(f'{yaml_path} not exists.')
        with open(yaml_path, 'r', encoding='utf-8') as f:
            ds_cfg = read_data_yaml(f.read())
        data_root = ds_cfg['path']
        self.names = ds_cfg.get('names', {})

        img_dir = os.path.join(data_root, mode, 'imgs')
        msk_dir = os.path.join(data_root, mode, 'masks')
        if not os.path.isdir(img_dir):
            raise RuntimeError(f'Image directory: {img_dir} does not exist.')
        if not os.path.isdir(msk_dir):
            raise RuntimeError(f'Mask directory: {msk_dir} does not exist.')

        if mode == 'train':
            self.transform = TrainTransform(config, identity_norm=True,
                                            square_size=config.train_size)
        else:
            self.transform = EvalTransform(config, identity_norm=True,
                                           square_size=config.test_size)

        self.images, self.masks = [], []
        for fn in sorted(os.listdir(img_dir)):
            base = os.path.splitext(fn)[0]
            self.images.append(os.path.join(img_dir, fn))
            self.masks.append(os.path.join(msk_dir, base + '.png'))
