"""Import a reference-framework checkpoint (.pth) into a checkpoint of the
PyTorch port (counterpart of tools/import_reference.py).

One-command migration for weights trained with
`acai66/realtime-semantic-segmentation-pytorch` (reference
core/base_trainer.py:142-163 saves {'state_dict': ...}):

    python tools/torch_import_reference.py --model bisenetv2 \
        --num_class 19 --pth reference_best.pth --out save/imported.ckpt

The output is a weights checkpoint ("best" format: meta.json with
`imported_from`, and state.pt) that `main_torch.py --load_ckpt_path`
accepts for validation, prediction and fine-tuning. The state_dict is
mapped by call order (rtseg_tpu_torch/utils/transplant.py: registration
order with the per-architecture SD_REORDER fixups, zipped with the
port model's Flax-path leaves) and loaded into the model strictly. Host
work on the CPU: no card is needed.
"""

import argparse
import sys
from os import path

sys.path.append(path.dirname(path.dirname(path.abspath(__file__))))


def trace_side(args) -> tuple:
    """The trace input's (height, width): PAN's pyramid ladder needs a
    deepest level that survives three 2x2 max-pools, so smp models take
    at least 128 (256 on MiT encoders, whose PAN runs at output stride
    32; reference models/__init__.py:71-75)."""
    min_side = 0
    if args.model == 'smp':
        min_side = 256 if (args.encoder or '').startswith('mit_') else 128
    return max(args.imgh, min_side), max(args.imgw, min_side)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument('--model', type=str, required=True)
    ap.add_argument('--encoder', type=str, default=None,
                    help="for --model smp: encoder name (e.g. resnet18, "
                         "resnet101)")
    ap.add_argument('--decoder', type=str, default=None,
                    help='for --model smp: one of the 9 smp decoders')
    ap.add_argument('--num_class', type=int, required=True)
    ap.add_argument('--use_aux', action='store_true')
    ap.add_argument('--use_detail_head', action='store_true')
    ap.add_argument('--pth', type=str, required=True,
                    help='reference .pth checkpoint (incl. smp-family '
                         'checkpoints such as the published KD teacher)')
    ap.add_argument('--out', type=str, required=True,
                    help='output checkpoint directory')
    ap.add_argument('--imgh', type=int, default=64,
                    help='trace height (any valid size works)')
    ap.add_argument('--imgw', type=int, default=64)
    args = ap.parse_args(argv)
    if args.model == 'smp' and not (args.encoder and args.decoder):
        ap.error('--model smp requires --encoder and --decoder (the '
                 'reference stores neither in the .pth)')

    import numpy as np
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.train.checkpoint import save_weights_ckpt
    from rtseg_tpu_torch.utils.convert import load_jax_variables
    from rtseg_tpu_torch.utils.transplant import load_reference_pth

    cfg = SegConfig(model=args.model, encoder=args.encoder,
                    decoder=args.decoder, num_class=args.num_class,
                    use_aux=args.use_aux,
                    use_detail_head=args.use_detail_head)
    model = get_model(cfg, device='cpu')
    # smp reorder fixups are keyed by decoder (smp_unetpp, smp_pan, ...)
    reorder_key = (f'smp_{args.decoder}' if args.model == 'smp'
                   else args.model)
    imgh, imgw = trace_side(args)
    variables = load_reference_pth(
        args.pth, reorder_key, model,
        np.zeros((1, imgh, imgw, 3), np.float32))
    load_jax_variables(model, variables)      # strict both ways

    out = path.abspath(args.out)
    save_weights_ckpt(out, variables, cur_epoch=0, best_score=0.0,
                      imported_from=path.abspath(args.pth))
    n = sum(p.numel() for p in model.parameters())
    print(f'Imported {args.pth} -> {out} ({n / 1e6:.2f}M params). '
          f'Use --load_ckpt_path {args.out} for predict/val/fine-tune.')
    return 0


if __name__ == '__main__':
    sys.exit(main())
