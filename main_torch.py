"""Entry point of the PyTorch/CUDA port (counterpart of main.py): build the
config, overlay the command line, resolve, construct SegTrainer, then
predict (--is_testing) or train.

    python main_torch.py --dataset cityscapes --data_root data/cityscapes \\
        --model bisenetv2 --use_aux --total_epoch 2
    python main_torch.py --is_testing --test_data_folder imgs/ \\
        --load_ckpt_path save/best.ckpt --save_dir save
    python main_torch.py --device cpu ...      # the CPU, named explicitly
    torchrun --nproc_per_node N main_torch.py ...   # N cards, one a process
    python main_torch.py --multihost --coordinator_address HOST:PORT \\
        --process_id I --num_processes N --device cuda:K ...  # process I

It runs on the CUDA card (`--device cuda:K` names one of several).
`--device cpu` is the only other choice; this script takes it and passes
the remaining flags to the config parser
(rtseg_tpu_torch/config/parser.py, the JAX package's flags). Without a
card and without `--device cpu` SegTrainer raises. `main(argv, config)`
is the same from Python: `config` replaces main.py's default config, as
examples/ build theirs, and carries fields the parser has no flag for
(synthetic_len, segpipe_cache, aug_workers, device_prefetch,
device_norm). With `--is_testing` it writes the folder's colormapped
masks and blends under save_dir/predicts and save_dir/predicts_blend
(SegTrainer.predict) and returns (trainer, None).

Under torchrun (`python -m torch.distributed.run`) or with --multihost
each process trains on one card over NCCL (gloo with `--device cpu`): the
card `--device cuda:K` names, else cuda:LOCAL_RANK, else cuda:0, so
--multihost processes sharing a host each name their own. It is rank RANK
of the world (rtseg_tpu_torch/parallel/): train_bs and val_bs are per
rank, and the LR scales with the world size as the JAX package's does
with its devices. Run as a script, it closes the process group before it
exits.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Optional, Sequence

from rtseg_tpu_torch.config import SegConfig, load_parser
from rtseg_tpu_torch.parallel import close
from rtseg_tpu_torch.train import SegTrainer


def default_config() -> SegConfig:
    """main.py's config: BiSeNetv2 on 19-class Cityscapes."""
    return SegConfig(dataset='cityscapes', data_root='data/cityscapes',
                     num_class=19, model='bisenetv2')


def _device(name: str) -> str:
    if name not in ('cpu', 'cuda') and re.fullmatch(r'cuda:\d+', name) is None:
        raise argparse.ArgumentTypeError(
            f"{name!r}: expected cpu, cuda or cuda:N")
    return name


def split_device(argv: Sequence[str]):
    """(device or None, the other arguments): `--device cpu` or
    `--device=cpu` (cuda, or cuda:N for one card of several) is taken
    out of argv."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument('--device', type=_device)
    args, rest = p.parse_known_args(list(argv))
    return args.device, rest


def main(argv: Optional[Sequence[str]] = None,
         config: Optional[SegConfig] = None):
    """Run as main.py does; returns (trainer, the final val_best mIoU),
    or (trainer, None) after predicting under config.is_testing."""
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    config = default_config() if config is None else config
    if rest:
        config = load_parser(config, rest)
    config.resolve()
    trainer = SegTrainer(config, device=device)
    if config.is_testing:
        trainer.predict()
        return trainer, None
    return trainer, trainer.run()


if __name__ == '__main__':
    try:
        main()
    finally:
        close()
