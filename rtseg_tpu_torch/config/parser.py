"""CLI overlay for SegConfig (a copy of rtseg_tpu/config/parser.py).

Behavior parity with reference configs/parser.py:4-13: only flags the user
actually passed override config values — implemented by comparing against
argparse defaults (all None/absent) instead of the reference's
`exec(f"config.{k} = v")` pattern (parser.py:10).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from .base import SegConfig

MODEL_CHOICES = [
    'adscnet', 'aglnet', 'bisenetv1', 'bisenetv2', 'canet', 'cfpnet', 'cgnet',
    'contextnet', 'dabnet', 'ddrnet', 'dfanet', 'edanet', 'enet', 'erfnet',
    'esnet', 'espnet', 'espnetv2', 'farseenet', 'fastscnn', 'fddwnet',
    'fpenet', 'fssnet', 'icnet', 'lednet', 'linknet', 'lite_hrnet', 'liteseg',
    'mininet', 'mininetv2', 'ppliteseg', 'regseg', 'segnet', 'shelfnet',
    'sqnet', 'stdc', 'swiftnet', 'smp',
]

DECODER_CHOICES = ['deeplabv3', 'deeplabv3p', 'fpn', 'linknet', 'manet',
                   'pan', 'pspnet', 'unet', 'unetpp']


def _bool(s: str) -> bool:
    """Strict CLI boolean: unlike type=bool (where 'False' -> True) both
    states are expressible and typos fail loudly."""
    low = s.strip().lower()
    if low in ('1', 'true', 'yes', 'on'):
        return True
    if low in ('0', 'false', 'no', 'off'):
        return False
    raise argparse.ArgumentTypeError(f'expected a boolean, got {s!r}')


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='rtseg_tpu_torch: real-time '
                                'semantic segmentation on CUDA')
    # Dataset
    p.add_argument('--dataset', type=str, choices=['cityscapes', 'custom', 'synthetic'])
    p.add_argument('--data_root', type=str)
    p.add_argument('--num_class', type=int)
    p.add_argument('--ignore_index', type=int)
    # Model
    p.add_argument('--model', type=str, choices=MODEL_CHOICES)
    p.add_argument('--encoder', type=str)
    p.add_argument('--decoder', type=str, choices=DECODER_CHOICES)
    p.add_argument('--encoder_weights', type=str)
    p.add_argument('--backbone_ckpt', type=str)
    p.add_argument('--backbone_type', type=str)
    # Detail head
    p.add_argument('--use_detail_head', action='store_const', const=True)
    p.add_argument('--detail_thrs', type=float)
    p.add_argument('--detail_loss_coef', type=float)
    p.add_argument('--dice_loss_coef', type=float)
    p.add_argument('--bce_loss_coef', type=float)
    # Training
    p.add_argument('--total_epoch', type=int)
    p.add_argument('--base_lr', type=float)
    p.add_argument('--train_bs', type=int)
    p.add_argument('--use_aux', action='store_const', const=True)
    p.add_argument('--aux_coef', type=float, nargs='+')
    p.add_argument('--remat', action='store_const', const=True)
    # Validation
    p.add_argument('--val_bs', type=int)
    p.add_argument('--begin_val_epoch', type=int)
    p.add_argument('--val_interval', type=int)
    # Testing
    p.add_argument('--is_testing', action='store_const', const=True)
    p.add_argument('--test_bs', type=int)
    p.add_argument('--test_data_folder', type=str)
    p.add_argument('--colormap', type=str)
    p.add_argument('--save_mask', type=_bool)
    p.add_argument('--blend_prediction', type=_bool)
    p.add_argument('--blend_alpha', type=float)
    # Loss
    p.add_argument('--loss_type', type=str, choices=['ce', 'ohem'])
    p.add_argument('--class_weights', type=float, nargs='+')
    p.add_argument('--ohem_thrs', type=float)
    # Scheduler
    p.add_argument('--lr_policy', type=str, choices=['cos_warmup', 'linear', 'step'])
    p.add_argument('--warmup_epochs', type=int)
    # Optimizer
    p.add_argument('--optimizer_type', type=str, choices=['sgd', 'adam', 'adamw'])
    p.add_argument('--momentum', type=float)
    p.add_argument('--weight_decay', type=float)
    # Monitoring
    p.add_argument('--save_ckpt', type=_bool)
    p.add_argument('--save_dir', type=str)
    p.add_argument('--use_tb', type=_bool)
    p.add_argument('--tb_log_dir', type=str)
    p.add_argument('--ckpt_name', type=str)
    # Observability (segscope)
    p.add_argument('--use_obs', type=_bool)
    p.add_argument('--obs_dir', type=str)
    p.add_argument('--watchdog', type=_bool)
    p.add_argument('--watchdog_min_s', type=float)
    p.add_argument('--watchdog_factor', type=float)
    p.add_argument('--obs_stall_trace', type=_bool)
    # Device profiling (segprof)
    p.add_argument('--profile_every', type=int)
    p.add_argument('--profile_capture_iters', type=int)
    # Training setting
    # tri-state: absent -> None (defer to compute_dtype), true -> bf16,
    # false -> force fp32 (reachable from the CLI, unlike store_const)
    p.add_argument('--amp_training', nargs='?', const=True, default=None,
                   type=_bool)
    p.add_argument('--log_interval', type=int)
    p.add_argument('--resume_training', type=_bool)
    p.add_argument('--load_ckpt', type=_bool)
    p.add_argument('--load_ckpt_path', type=str)
    p.add_argument('--base_workers', type=int)
    p.add_argument('--random_seed', type=int)
    p.add_argument('--use_ema', action='store_const', const=True)
    # Augmentation
    p.add_argument('--crop_size', type=int)
    p.add_argument('--crop_h', type=int)
    p.add_argument('--crop_w', type=int)
    p.add_argument('--scale', type=float)
    p.add_argument('--randscale', type=float, nargs='+')
    p.add_argument('--brightness', type=float)
    p.add_argument('--contrast', type=float)
    p.add_argument('--saturation', type=float)
    p.add_argument('--h_flip', type=float)
    p.add_argument('--v_flip', type=float)
    # Parallel
    p.add_argument('--sync_bn', type=_bool)
    p.add_argument('--spatial_partition', type=int)
    p.add_argument('--s2d_stem', type=_bool)
    p.add_argument('--segnet_pack', type=_bool)
    p.add_argument('--detail_remat', type=_bool)
    p.add_argument('--multihost', action='store_const', const=True)
    p.add_argument('--coordinator_address', type=str)
    p.add_argument('--process_id', type=int)
    p.add_argument('--num_processes', type=int)
    # KD
    p.add_argument('--kd_training', action='store_const', const=True)
    p.add_argument('--teacher_ckpt', type=str)
    p.add_argument('--teacher_model', type=str)
    p.add_argument('--teacher_encoder', type=str)
    p.add_argument('--teacher_decoder', type=str)
    p.add_argument('--kd_loss_type', type=str, choices=['kl_div', 'mse'])
    p.add_argument('--kd_loss_coefficient', type=float)
    p.add_argument('--kd_temperature', type=float)
    # Warm starts (segwarm)
    p.add_argument('--compile_cache', type=_bool)
    p.add_argument('--compile_cache_dir', type=str)
    p.add_argument('--compile_workers', type=int)
    # Numerics
    p.add_argument('--compute_dtype', type=str, choices=['bfloat16', 'float32'])
    return p


def load_parser(config: SegConfig, argv: Optional[list] = None) -> SegConfig:
    args = get_parser().parse_args(argv)
    names = {f.name for f in dataclasses.fields(SegConfig)}
    for k, v in vars(args).items():
        if v is None or k not in names:
            continue
        if k == 'randscale' and isinstance(v, list):
            v = v[0] if len(v) == 1 else tuple(v)
        setattr(config, k, v)
    return config
