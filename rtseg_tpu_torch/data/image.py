"""Image files by their signature: the port's replacement of
`PIL.Image.open(...).convert(mode)` wherever the JAX package opens an
image (data/protocol.py, test_folder.py, serve/server.py,
utils/check_datasets.py).

A file that opens with the PNG signature goes to data/png.py, one that
opens with a JPEG SOI and marker to data/jpeg.py. Any other format
raises NotImplementedError (the port decodes these two; PIL opens more
in the JAX package: a deliberate difference, ROADMAP.md Queue 3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import jpeg, png

# the bytes `kind` needs to tell the formats apart
HEAD = 8


def kind(head: bytes, what: str) -> str:
    """'png' or 'jpeg' from a file's first bytes; other formats raise
    NotImplementedError naming `what`."""
    if head[:8] == png.SIGNATURE:
        return 'png'
    if head[:3] == jpeg.SIGNATURE:
        return 'jpeg'
    raise NotImplementedError(
        f'{what} is neither a PNG nor a JPEG: the port decodes those two '
        f'formats only (convert it to one of them; ROADMAP.md Queue 3)')


def decode(data: bytes, mode: str, what: str = 'the image') -> np.ndarray:
    """(H, W, 3) uint8 for mode 'RGB', (H, W) uint8 for 'L'."""
    module = png if kind(data[:HEAD], what) == 'png' else jpeg
    return module.decode(data, mode)


def read(path: str, mode: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert(mode))` for a PNG or a
    JPEG, mode 'RGB' or 'L'."""
    with open(path, 'rb') as f:
        return decode(f.read(), mode, path)


def read_size(path: str) -> Tuple[int, int]:
    """(height, width) from the header alone, without decoding."""
    with open(path, 'rb') as f:
        head = f.read(HEAD)
    module = png if kind(head, path) == 'png' else jpeg
    return module.read_size(path)
