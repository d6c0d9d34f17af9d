"""Capture and aggregate a train-step torch.profiler trace by model module
(counterpart of tools/profile_step.py).

Builds one model's train step (or, with --eval, its eval step: the EMA
forward, K1 and K2) on a resident seeded batch, runs one warm-up step
(the first call of the input signature: cuDNN's algorithm choice, the
kernels' build), traces --iters fenced steps with torch.profiler and
module ranges (rtseg_tpu_torch/obs/profile.py, the parser the trainer's
sampled profiling and the serve front end's `/debug/profile` use), and
prints the device time a step by module at --depth, with a row for the
device time no module launched, then the time by category.

    python tools/torch_profile_step.py --model bisenetv2 --batch 16 \
        --imgh 512 --imgw 1024
    python tools/torch_profile_step.py --model smp --encoder mit_b2 \
        --decoder fpn --depth 4
    python tools/torch_profile_step.py --device cpu --model fastscnn \
        --batch 2 --imgh 64 --imgw 64 --iters 2   # the CPU's op events
    python tools/torch_profile_step.py --no-capture --trace-dir DIR
    python tools/torch_profile_step.py --inspect --trace-dir DIR

On the card the trace has a GPU track and the table is device time; on
the CPU (--device cpu) there is none, and the parser falls back to the
CPU's op events, which the table says. The traced region is guarded: a
profile whose steps met a new input signature (the step's signature
count grew) raises instead of attributing one-time costs to modules. The
JAX tool's --hires-remat, --detail-remat and --pack-fullres are TPU
levers the port refuses (ops/s2d.py, nn/packed.py), so they are not
taken here. The trace is written under --trace-dir (default the
temporary directory's rtseg_profile/<model>).
"""

import argparse
import json
import os
import sys
import tempfile
from os import path

sys.path.append(path.dirname(path.dirname(path.abspath(__file__))))

import numpy as np  # noqa: E402

from rtseg_tpu_torch.obs.core import cache_size  # noqa: E402
from rtseg_tpu_torch.obs.profile import (Capture, fence,  # noqa: E402
                                         load_trace_events, parse_trace)


def build(model_name, batch, h, w, device, dtype, encoder, decoder,
          eval_mode):
    """(step, args): the train step with its state and a seeded resident
    batch, or the eval step of the EMA model with it."""
    import torch
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.models.registry import (AUX_MODELS,
                                                 DETAIL_HEAD_MODELS,
                                                 get_model)
    from rtseg_tpu_torch.train.optim import get_optimizer
    from rtseg_tpu_torch.train.state import TrainState, make_ema_model
    from rtseg_tpu_torch.train.step import build_eval_step, build_train_step
    from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                               load_jax_variables)
    cfg = SegConfig(dataset='synthetic', model=model_name, num_class=19,
                    compute_dtype=dtype, train_bs=batch,
                    encoder=encoder, decoder=decoder,
                    use_aux=model_name in AUX_MODELS and not eval_mode,
                    use_detail_head=(model_name in DETAIL_HEAD_MODELS
                                     and not eval_mode),
                    use_ema=True, loss_type='ohem',
                    save_dir=os.path.join(tempfile.gettempdir(),
                                          'rtseg_profile'))
    cfg.resolve(num_devices=1)
    cfg.resolve_schedule(train_num=batch * 1000)
    model = get_model(cfg, device=device).eval()
    load_jax_variables(model, flax_init_variables(model, 0))
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.rand(batch, h, w, 3).astype(np.float32)).to(device)
    masks = torch.from_numpy(
        rng.randint(0, 19, (batch, h, w)).astype(np.int32)).to(device)
    if eval_mode:
        return build_eval_step(cfg, model, device), (images, masks), model
    state = TrainState(step=0, model=model,
                       optimizer=get_optimizer(cfg, model.parameters()),
                       ema_model=make_ema_model(model))
    return build_train_step(cfg), (state, images, masks), model


def capture(step, args, model, trace_dir, iters, depth):
    """One warm-up call, then `iters` fenced calls under a Capture with
    module ranges on `model`; raises when a traced call met a new input
    signature."""
    step(*args)
    fence()
    size = cache_size(step)
    cap = Capture((model,), depth)
    try:
        for _ in range(iters):
            step(*args)
        fence()
    finally:
        path_ = cap.stop(trace_dir)
    if cache_size(step) != size:
        raise RuntimeError('a traced step met a new input signature; its '
                           'one-time costs would read as module time')
    return path_


def inspect(trace_dir, n=15):
    events, meta = load_trace_events(trace_dir)
    print('processes:', meta['pid_names'], 'gpus:', len(meta['gpus']))
    for e in sorted(events, key=lambda e: -float(e.get('dur', 0)))[:n]:
        print(json.dumps(e)[:400])


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--model', default='ddrnet')
    ap.add_argument('--encoder', default='resnet18',
                    help="smp's encoder (--model smp)")
    ap.add_argument('--decoder', default='deeplabv3p',
                    help="smp's decoder (--model smp)")
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--imgh', type=int, default=512)
    ap.add_argument('--imgw', type=int, default=1024)
    ap.add_argument('--iters', type=int, default=6)
    ap.add_argument('--depth', type=int, default=1,
                    help='module-path depth to aggregate at')
    ap.add_argument('--compute_dtype', default='bfloat16')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='the card by default; cpu must be named')
    ap.add_argument('--trace-dir', default=None)
    ap.add_argument('--eval', action='store_true',
                    help='profile the eval step (EMA forward, K1, K2) '
                         'instead of the train step')
    ap.add_argument('--no-capture', action='store_true',
                    help='aggregate an existing trace only')
    ap.add_argument('--inspect', action='store_true',
                    help='dump the longest raw events and exit')
    ap.add_argument('--obs-dir', default=None,
                    help='write a profile event (model, ms/iter, trace '
                         'dir, module shares) as JSONL under this dir, '
                         'readable by tools/torch_segscope.py')
    args = ap.parse_args(argv)
    trace_dir = args.trace_dir or os.path.join(
        tempfile.gettempdir(), 'rtseg_profile', args.model)

    sink = None
    if args.obs_dir:
        from rtseg_tpu_torch import obs
        sink = obs.init_run(args.obs_dir,
                            meta={'tool': 'torch_profile_step',
                                  'model': args.model,
                                  'batch': args.batch,
                                  'imgh': args.imgh, 'imgw': args.imgw})

    try:
        if not args.no_capture and not args.inspect:
            if args.device == 'cuda' and not torch.cuda.is_available():
                print('torch_profile_step: no CUDA device; pass --device '
                      'cpu to profile on the CPU', file=sys.stderr)
                return 2
            device = torch.device(args.device)
            step, step_args, model = build(
                args.model, args.batch, args.imgh, args.imgw, device,
                args.compute_dtype, args.encoder, args.decoder, args.eval)
            where = capture(step, step_args, model, trace_dir, args.iters,
                            args.depth)
            name = (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'CPU')
            print(f'# traced {args.iters} iters on {name} into {where}')
        if args.inspect:
            inspect(trace_dir)
            return 0
        prof = parse_trace(trace_dir, depth=args.depth)
        total = prof.busy_us
        if not prof.device_track:
            print('# WARNING: no GPU track in the trace: aggregated the '
                  "CPU's op events", flush=True)
        rows = dict(prof.modules)
        # device time no module launched gets a row of its own: the table
        # sums to its TOTAL
        residue = sum(prof.categories.values()) - sum(rows.values())
        if residue > 1e-4 * max(total, 1e-9):
            rows['(no module)'] = residue
        summed = sum(rows.values()) or 1.0
        print(f'\n| module (depth {args.depth}) | device ms/iter | share |')
        print('|---|---|---|')
        for mod, dur in sorted(rows.items(), key=lambda kv: -kv[1])[:20]:
            print(f'| {mod} | {dur / 1000 / args.iters:.3f} | '
                  f'{100 * dur / summed:.1f}% |')
        print(f'| TOTAL | {summed / 1000 / args.iters:.3f} | 100% | '
              f'(busy {total / 1000 / args.iters:.3f} ms/iter, '
              f'{100 * prof.busy_frac:.1f}% of the capture window, '
              f'{100 * prof.attributed_frac:.1f}% attributed)')
        print('\n| category | device ms/iter |')
        print('|---|---|')
        for cat, dur in sorted(prof.categories.items(),
                               key=lambda kv: -kv[1])[:15]:
            print(f'| {cat} | {dur / 1000 / args.iters:.3f} |')
        if sink is not None:
            sink.emit(prof.to_event(
                model=args.model, mode='eval' if args.eval else 'train',
                iters=args.iters, trace_dir=trace_dir,
                ms_per_iter=round(total / 1000 / args.iters, 3),
                module_shares={mod: round(dur / summed, 4)
                               for mod, dur in sorted(
                                   rows.items(), key=lambda kv: -kv[1])
                               [:20]}))
        return 0
    finally:
        if sink is not None:
            sink.close()


if __name__ == '__main__':
    sys.exit(main())
