"""Convert a JAX package checkpoint (an orbax directory written by
rtseg_tpu/train/checkpoint.py) into the PyTorch port's checkpoint format,
which `main_torch.py --load_ckpt_path` reads:

    python tools/orbax_to_torch.py --src save/last.ckpt \
        --dst save_torch/last.ckpt --optimizer_type sgd

A train checkpoint ("last") becomes a train checkpoint the port resumes
from (weights, BatchNorm statistics, EMA, step, and the optimizer's
buffers: SGD's momentum, Adam's and AdamW's moments and count); its
optimizer is read from the tree and must be --optimizer_type, the
config.optimizer_type of the run that resumes it. A weights checkpoint
("best", or the JAX package's tools/import_reference.py output) needs no
optimizer type.

This is the one tool that needs both installations: it restores the
orbax tree without a template (orbax.checkpoint, hence JAX) and writes
it with torch through rtseg_tpu_torch (train/checkpoint.py:
from_orbax_tree). It imports nothing of rtseg_tpu. Run it where orbax is
installed; the card's machine has no orbax.
"""

import argparse
import os
import sys
from os import path

sys.path.append(path.dirname(path.dirname(path.abspath(__file__))))


def convert(src: str, dst: str, optimizer_type=None) -> dict:
    """Read the orbax checkpoint `src`, write the port's checkpoint `dst`;
    returns the meta written."""
    import orbax.checkpoint as ocp
    from rtseg_tpu_torch.train.checkpoint import (from_orbax_tree, load_meta,
                                                  write_checkpoint)
    src = os.path.abspath(src)
    tree = ocp.PyTreeCheckpointer().restore(src)
    payload, meta = from_orbax_tree(tree, load_meta(src), optimizer_type)
    write_checkpoint(os.path.abspath(dst), payload, meta)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument('--src', required=True,
                    help='orbax checkpoint directory of the JAX package')
    ap.add_argument('--dst', required=True,
                    help='checkpoint directory to write for the port')
    ap.add_argument('--optimizer_type', choices=('sgd', 'adam', 'adamw'),
                    default=None,
                    help='the optimizer of a train checkpoint')
    args = ap.parse_args(argv)
    meta = convert(args.src, args.dst, args.optimizer_type)
    print(f'Converted {args.src} -> {args.dst} (kind {meta.get("kind")}'
          f'{", optimizer " + meta["optimizer"] if "optimizer" in meta else ""}'
          f'). Use --load_ckpt_path {args.dst} with main_torch.py.')
    return 0


if __name__ == '__main__':
    sys.exit(main())
