#!/usr/bin/env python
"""Export a model of the PyTorch/CUDA port to a `torch.export` serving
artifact (counterpart of tools/export.py).

The weights are stored with the program, the head is int8 argmax (or fp32
logits with --logits). The program is exported on the CPU; a serving
process loads it onto the card (tools/torch_segserve.py serve
--artifact, ServeEngine.from_artifact).

    python tools/torch_export.py --model ddrnet --num_class 19 \
        --load_ckpt_path save/best.ckpt --out save/ddrnet.pt2
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtseg_tpu_torch.config import SegConfig                   # noqa: E402
from rtseg_tpu_torch.export import (SUFFIX, export_model,      # noqa: E402
                                    save_exported)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--model', type=str, default='bisenetv2')
    ap.add_argument('--encoder', type=str, default=None)
    ap.add_argument('--decoder', type=str, default=None)
    ap.add_argument('--num_class', type=int, default=19)
    ap.add_argument('--use_aux', action='store_true',
                    help='model was trained with auxiliary heads (its ckpt '
                         'params include them; needed for restore)')
    ap.add_argument('--use_detail_head', action='store_true',
                    help='STDC detail-head checkpoint')
    ap.add_argument('--compute_dtype', type=str, default='bfloat16',
                    choices=['bfloat16', 'float32'],
                    help='graph compute dtype; use float32 for CPU serving')
    ap.add_argument('--platforms', type=str, default='cpu,cuda',
                    help='comma-separated devices the artifact may be '
                         'loaded on (cpu, cuda)')
    ap.add_argument('--imgh', type=int, default=512)
    ap.add_argument('--imgw', type=int, default=1024)
    ap.add_argument('--batch', type=int, default=1,
                    help='0 exports a symbolic (any-size) batch dimension')
    ap.add_argument('--logits', action='store_true',
                    help='export fp32 logits instead of the int8 argmax head')
    ap.add_argument('--load_ckpt_path', type=str, default=None,
                    help='a checkpoint of the port (train/checkpoint.py); '
                         'without it, Flax\'s initializers from seed 0')
    ap.add_argument('--out', type=str, default=None)
    args = ap.parse_args(argv)

    cfg = SegConfig(dataset='synthetic', model=args.model,
                    num_class=args.num_class,
                    use_aux=args.use_aux,
                    use_detail_head=args.use_detail_head,
                    compute_dtype=args.compute_dtype,
                    save_dir=os.path.join(tempfile.gettempdir(),
                                          'rtseg_export'),
                    use_tb=False)
    if args.encoder:
        cfg = cfg.replace(encoder=args.encoder)
    if args.decoder:
        cfg = cfg.replace(decoder=args.decoder)
    cfg.resolve(num_devices=1)

    exported = export_model(cfg, imgh=args.imgh, imgw=args.imgw,
                            batch=args.batch or None,
                            argmax=not args.logits,
                            ckpt_path=args.load_ckpt_path,
                            platforms=tuple(
                                p.strip() for p in args.platforms.split(',')
                                if p.strip()))
    out = args.out or os.path.join(cfg.save_dir, args.model + SUFFIX)
    out = save_exported(exported, out)
    print(f'exported {args.model} ({args.imgh}x{args.imgw}, '
          f'batch={"poly" if not args.batch else args.batch}, '
          f'head={"logits" if args.logits else "int8 argmax"}) -> {out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
