"""Logging, seeding, config files and the TensorBoard writer (counterpart
of rtseg_tpu/utils/misc.py)."""

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


class TBWriter:
    """TensorBoard scalar writer over torch.utils.tensorboard; a no-op
    when config.use_tb is off or on a rank other than the main one.

    Where the JAX class goes silent without TensorBoard, this one logs
    one warning that names the missing package and then writes nothing:
    the run goes on without TB files, and the switch is not ignored
    without a word."""

    def __init__(self, config, main_rank: bool):
        self._w = None
        if not (config.use_tb and main_rank):
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            logging.getLogger(config.logger_name).warning(
                f'use_tb: TensorBoard logging is off for this run: '
                f'torch.utils.tensorboard needs the tensorboard package '
                f'({e})')
            return
        mkdir(config.tb_log_dir)
        self._w = SummaryWriter(config.tb_log_dir)

    @property
    def active(self) -> bool:
        return self._w is not None

    def add_scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def add_scalars(self, scalars, step):
        """Write a dict of host scalars at one step. Callers read their
        device values back in one batch a log interval (see
        SegTrainer._flush_tb) before handing them here."""
        if self._w is not None:
            for tag, value in scalars.items():
                self._w.add_scalar(tag, float(value), int(step))

    def close(self):
        if self._w is not None:
            self._w.close()
