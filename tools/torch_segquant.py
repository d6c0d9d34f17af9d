#!/usr/bin/env python
"""segquant for the PyTorch/CUDA port: a post-training int8 quantization
report for the model zoo (counterpart of tools/segquant.py).

For each model: quantize the weights per-channel symmetric int8
(rtseg_tpu_torch/quant/ptq.py), run the deterministic calibration forward
(rtseg_tpu_torch/quant/calibrate.py) over a seeded sample slice on the
card, and print the evidence: weight bytes f32 vs int8, f32-vs-int8
argmax agreement, mIoU delta, and the max-drop gate verdict.

    # synthetic calibration slice (seeded, through the serving preprocess)
    python tools/torch_segquant.py --models fastscnn,bisenetv2 --samples 8

    # real eval slice from a segpipe PackedCache (ground-truth mIoU)
    python tools/torch_segquant.py --models fastscnn \
        --calib-cache /data/cache/cityscapes-val-... --samples 16

    # write the flagship QuantRecord for inspection / diffing
    python tools/torch_segquant.py --models fastscnn --out /tmp/QUANT.json

    # on the CPU, named explicitly (the card is the default)
    python tools/torch_segquant.py --device cpu ...

`--activations` additionally calibrates per-tensor activation scales and
quantizes the input boundary (QDQ). Weights come from --ckpt (a
checkpoint of the port) or Flax's initializers drawn from seed 0
(utils/convert.py; not the JAX tool's PRNGKey(0) values). Determinism:
same models + samples + seed (+ cache) give byte-identical records.

Exit codes: 0 every model passed its gate, 1 any gate failure or model
error, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_MODELS = 'fastscnn'


def _calibration_slice(cfg, args, buckets):
    """(images, masks, source, indices): a segpipe PackedCache (eval
    suffix applied, ground truth) or a seeded synthetic batch through the
    real serving preprocess."""
    import numpy as np
    from rtseg_tpu_torch.quant import select_calibration_indices
    from rtseg_tpu_torch.serve import encode_png, make_preprocess, \
        synth_images

    if args.calib_cache:
        from rtseg_tpu_torch.data.segpipe.cache import PackedCache
        from rtseg_tpu_torch.data.transforms import EvalTransform
        cache = PackedCache(args.calib_cache)
        indices = select_calibration_indices(len(cache), args.samples,
                                             seed=args.seed)
        tf = EvalTransform(cfg)
        pairs = [tf.suffix(np.asarray(img), np.asarray(msk))
                 for img, msk in (cache.read(i) for i in indices)]
        name = os.path.basename(os.path.normpath(args.calib_cache))
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]),
                f'segpipe:{name}', indices)
    preprocess = make_preprocess(cfg)
    raws = synth_images([buckets[0]], seed=args.seed,
                        per_shape=max(1, args.samples))
    return (np.stack([preprocess(encode_png(im)) for im in raws]),
            None, 'synthetic', None)


def quantize_one(name: str, args):
    """Quantize + calibrate one zoo model; returns the QuantRecord."""
    import tempfile
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.models.registry import get_model
    from rtseg_tpu_torch.quant import calibrate, quantize_variables
    from rtseg_tpu_torch.serve.engine import resolve_device
    from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                               load_jax_variables,
                                               to_jax_variables)

    cfg = SegConfig(dataset='synthetic', model=name,
                    num_class=args.num_class,
                    compute_dtype=args.compute_dtype,
                    save_dir=os.path.join(tempfile.gettempdir(),
                                          'segquant_cli'), use_tb=False)
    cfg.resolve(num_devices=1)
    net = get_model(cfg, device=resolve_device(args.device)).eval()
    load_jax_variables(net, flax_init_variables(net, 0))
    if args.ckpt:
        from rtseg_tpu_torch.train.checkpoint import restore_weights
        restore_weights(args.ckpt, net)
    variables = to_jax_variables(net)
    qvariables = quantize_variables(variables)
    buckets = [(args.imgh, args.imgw)]
    images, masks, source, indices = _calibration_slice(cfg, args,
                                                        buckets)
    return calibrate(net, variables, qvariables, images, masks,
                     compute_dtype=cfg.compute_dtype,
                     num_class=args.num_class, max_drop=args.max_drop,
                     activations=args.activations, source=source,
                     seed=args.seed, indices=indices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='torch_segquant', description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--models', default=DEFAULT_MODELS,
                    help='comma-separated registry models')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default=None,
                    help='the card by default; cpu must be named')
    ap.add_argument('--num-class', type=int, default=19)
    ap.add_argument('--compute-dtype', default='float32')
    ap.add_argument('--imgh', type=int, default=256)
    ap.add_argument('--imgw', type=int, default=512)
    ap.add_argument('--samples', type=int, default=8,
                    help='calibration sample count (seeded selection)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--max-drop', type=float, default=0.05,
                    help='mIoU-drop gate per model (vs ground truth '
                         'with --calib-cache, vs the f32 forward '
                         'otherwise; the record labels which)')
    ap.add_argument('--activations', action='store_true',
                    help='also calibrate activation scales + quantize '
                         'the input boundary (QDQ)')
    ap.add_argument('--calib-cache', default=None,
                    help='segpipe PackedCache dir (real samples + '
                         'ground-truth mIoU)')
    ap.add_argument('--ckpt', default=None,
                    help='checkpoint of the port to quantize (default: '
                         'Flax\'s initializers from seed 0; structural '
                         'and agreement evidence only)')
    ap.add_argument('--out', default=None, metavar='PATH',
                    help='write the LAST model\'s QuantRecord here '
                         '(record_to_json canonical bytes)')
    ap.add_argument('--json', action='store_true',
                    help='one full QuantRecord JSON line per model')
    args = ap.parse_args(argv)

    from rtseg_tpu_torch.quant import record_to_json

    models = [m.strip() for m in args.models.split(',') if m.strip()]
    if not models:
        print('torch_segquant: no models', file=sys.stderr)
        return 2
    if not args.json:
        print(f'| model | f32 MiB | int8 MiB | quantized leaves | '
              f'agreement | mIoU drop ({("gt" if args.calib_cache else "vs f32")}) '
              f'| gate (<= {args.max_drop}) |')
        print('|---|---|---|---|---|---|---|')
    failures = 0
    record = None
    for name in models:
        try:
            record = quantize_one(name, args)
        except Exception as e:   # noqa: BLE001 (one broken model must
            # not hide the rest of the table; it still fails the run)
            failures += 1
            msg = ' '.join(f'{type(e).__name__}: {e}'.split())[:120]
            if args.json:
                print(json.dumps({'model': name, 'error': msg}),
                      flush=True)
            else:
                print(f'| {name} | FAILED: {msg} | — | — | — | — | — |',
                      flush=True)
            continue
        if not record['gate']['passed']:
            failures += 1
        if args.json:
            print(json.dumps({'model': name, **record},
                             sort_keys=True), flush=True)
        else:
            w = record['weights']
            f32_mib = w['f32'] / 2**20
            int8_mib = w['int8'] / 2**20
            print(f'| {name} | {f32_mib:.2f} | {int8_mib:.2f} | '
                  f'{w["quantized_leaves"]}/{w["total_leaves"]} | '
                  f'{record["agreement_frac"]:.4f} | '
                  f'{record["miou"]["drop"]:.4f} | '
                  f'{"PASS" if record["gate"]["passed"] else "FAIL"} |',
                  flush=True)
    if not args.json:
        print(f'\ncalibration: {args.samples} samples, seed {args.seed}, '
              f'{args.imgh}x{args.imgw}, '
              + (f'cache {args.calib_cache}' if args.calib_cache
                 else 'synthetic (mIoU drop is f32-forward-relative)'))
    if args.out and record is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(record_to_json(record))
        print(f'torch_segquant: record -> {args.out}', flush=True)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
