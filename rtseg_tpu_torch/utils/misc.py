"""Logging, seeding and config files (counterpart of
rtseg_tpu/utils/misc.py). TensorBoard's writer comes with the planes
(ROADMAP.md Queue 1, "The planes"): the trainer refuses use_tb."""

from __future__ import annotations

import json
import logging
import os
import random
import sys

import numpy as np
import torch


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators. The port's
    own randomness (weights from the Flax initializers, dropout masks,
    augmentation draws) takes explicit seeds from the config."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_logger(config, main_rank: bool) -> logging.Logger:
    """stderr + file logger (save_dir/<logger_name>.log), stdlib-based.
    The main rank logs at INFO into both; the other ranks of a process
    group log errors alone, to stderr. The first call for a logger name
    sets its handlers; later calls return it as it is."""
    logger = logging.getLogger(config.logger_name)
    logger.setLevel(logging.INFO if main_rank else logging.ERROR)
    logger.propagate = False          # no second line through the root
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        '%(asctime)s | %(levelname)s | %(message)s', '%Y-%m-%d %H:%M:%S')
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if main_rank:
        mkdir(config.save_dir)
        fh = logging.FileHandler(
            os.path.join(config.save_dir, f'{config.logger_name}.log'))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def save_config(config) -> None:
    """The resolved config as save_dir/config.json (the trainer's main
    rank writes it)."""
    mkdir(config.save_dir)
    config.save(os.path.join(config.save_dir, 'config.json'))


def log_config(config, logger) -> None:
    msg = json.dumps(config.to_dict(), indent=2, default=str)
    logger.info(f'Config:\n{msg}')
