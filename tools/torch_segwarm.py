#!/usr/bin/env python
"""torch_segwarm — the port's compile-cache CLI (rtseg_tpu_torch/warm/;
counterpart of tools/segwarm.py).

What the port compiles are the shared libraries it builds from its own
sources at first use: the CUDA kernels K1 and K2 (nvcc, sm_90a) and the
host library (cc). This tool prebuilds them into a cache directory,
reports what the directory holds, and clears it.

Usage:
    # prebuild the libraries (the host library; K1 and K2 unless
    # --device cpu), loaded from the cache by the next trainer or server
    python tools/torch_segwarm.py warm --cache-dir /ssd/segwarm

    # ... and an engine init a model under the cache
    python tools/torch_segwarm.py warm --cache-dir /ssd/segwarm \
        --models fastscnn,bisenetv2 --buckets 512x1024 --batch 8 \
        --ckpt save/best.ckpt

    # ... and a config's first train and eval step under the cache
    python tools/torch_segwarm.py warm --cache-dir /ssd/segwarm --train \
        --models fastscnn --train-bs 8 --crop 256
    python tools/torch_segwarm.py warm --cache-dir /ssd/segwarm --train \
        --config save/run1/config.json

    # entries, bytes, per-entry provenance, recorded fallbacks
    python tools/torch_segwarm.py stats --cache-dir /ssd/segwarm [--json]
    # gate: exit 1 if any cached library failed to load and was rebuilt
    python tools/torch_segwarm.py stats --cache-dir /ssd/segwarm --check

    python tools/torch_segwarm.py clear --cache-dir /ssd/segwarm

Entries bind the torch and CUDA versions, the compiler's version, the
flags, the sources and the cards of the machine that built them: a
mismatch is a miss, never a stale hit. The engine's CUDA graphs are
captured at every start (a graph cannot be stored), so `--models` warms
the libraries of the serving path, not the graphs.

Exit codes: 0 ok, 1 --check failed or a build failed, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtseg_tpu_torch.warm import (clear_cache,                 # noqa: E402
                                  enable_compile_cache, scan_cache)


def _mib(n: int) -> str:
    return f'{n / 2**20:.1f} MiB'


def _build_cfg(args, model: str):
    from rtseg_tpu_torch.config import SegConfig
    cfg = SegConfig(dataset='synthetic', model=model,
                    num_class=args.num_class,
                    compute_dtype=args.compute_dtype,
                    compile_cache=True, compile_cache_dir=args.cache_dir,
                    save_dir=os.path.join(args.cache_dir, 'segwarm_cli'),
                    use_tb=False, use_obs=False)
    cfg.resolve(num_devices=1)
    return cfg


def _warm_libraries(args) -> int:
    """The host library and, on the card, K1 and K2, through the
    process's cache; a failed build raises."""
    from rtseg_tpu_torch import native
    from rtseg_tpu_torch.ops import cuda_build
    if not native.available():
        raise RuntimeError(f'the host library did not build: '
                           f'{native.build_error()}')
    n = 1
    if args.device != 'cpu':
        cuda_build.build()
        n += len(cuda_build.KERNELS)
    print(f'  libraries: {n} ({"host" if n == 1 else "host, K1, K2"})',
          flush=True)
    return n


def _warm_serve(args) -> int:
    """One ServeEngine.from_config a model under the cache."""
    from rtseg_tpu_torch.serve import ServeEngine, parse_buckets
    buckets = parse_buckets(args.buckets)
    for model in args.model_list:
        t0 = time.perf_counter()
        engine = ServeEngine.from_config(_build_cfg(args, model), buckets,
                                         args.batch, ckpt_path=args.ckpt,
                                         name=f'warm:{model}',
                                         device=args.device)
        st = engine.stats()
        print(f'  {model}: {st["executables"]} bucket(s) captured in '
              f'{time.perf_counter() - t0:.2f} s ({st["cache_hits"]} '
              f'libraries from the cache)', flush=True)
    return 0


def _warm_train(args) -> int:
    """A trainer a config under the cache, and its first train and eval
    step on a zero batch: the eval step acquires its kernel libraries
    (warm_step)."""
    import torch
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.train import SegTrainer
    configs = []
    if args.config:
        with open(args.config) as f:
            cfg = SegConfig.from_dict(json.load(f))
        cfg.compile_cache, cfg.compile_cache_dir = True, args.cache_dir
        cfg.use_tb = cfg.use_obs = False
        configs.append(cfg)
    else:
        for model in args.model_list:
            cfg = _build_cfg(args, model)
            cfg.train_bs = cfg.val_bs = args.train_bs
            cfg.crop_size = cfg.crop_h = cfg.crop_w = args.crop
            configs.append(cfg)
    for cfg in configs:
        cfg.load_ckpt = False
        t0 = time.perf_counter()
        trainer = SegTrainer(cfg, device=args.device)
        dev = trainer.device
        # the raw uint8 tail's steps take uint8 images and flip flags
        raw = cfg.device_norm_resolved
        imgs = torch.zeros((cfg.train_bs, cfg.crop_h, cfg.crop_w, 3),
                           dtype=torch.uint8 if raw else torch.float32,
                           device=dev)
        msks = torch.zeros((cfg.train_bs, cfg.crop_h, cfg.crop_w),
                           dtype=torch.int64, device=dev)
        flags = ((torch.zeros((cfg.train_bs, 2), dtype=torch.uint8,
                              device=dev),) if raw else ())
        trainer.train_step(trainer.state, imgs, msks, *flags)
        trainer.eval_step(imgs, msks)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        print(f'  {cfg.model}: train+eval steps (bs{cfg.train_bs}, '
              f'{cfg.crop_h}x{cfg.crop_w}) in '
              f'{time.perf_counter() - t0:.2f} s; '
              f'{trainer._exe_cache.stats()}', flush=True)
    return 0


def cmd_warm(args) -> int:
    args.model_list = [m.strip() for m in args.models.split(',')
                       if m.strip()]
    if args.config:
        args.train = True
    if args.train and not (args.model_list or args.config):
        print('torch_segwarm: warm --train needs --models or --config',
              file=sys.stderr)
        return 2
    enable_compile_cache(cache_dir=args.cache_dir)
    before = scan_cache(args.cache_dir)
    t0 = time.perf_counter()
    try:
        n = _warm_libraries(args)
        if args.train:
            _warm_train(args)
        elif args.model_list:
            _warm_serve(args)
    except RuntimeError as e:
        print(f'torch_segwarm: {e}', file=sys.stderr)
        return 1
    after = scan_cache(args.cache_dir)
    print(f'torch_segwarm: {n} libraries warm under {args.cache_dir} in '
          f'{time.perf_counter() - t0:.2f} s — '
          f'{after["n_entries"] - before["n_entries"]} built + stored '
          f'({_mib(after["bytes"] - before["bytes"])}), '
          f'{after["hits"] - before["hits"]} already cached, '
          f'{after["n_fallbacks"] - before["n_fallbacks"]} fallback(s)',
          flush=True)
    return 0


def cmd_stats(args) -> int:
    s = scan_cache(args.cache_dir)
    if args.json:
        print(json.dumps(s, indent=2, default=str))
    else:
        print(f'torch_segwarm stats — {s["cache_dir"]}')
        print(f'  entries   : {s["n_entries"]} | {_mib(s["bytes"])} | '
              f'{s["hits"]} recorded hit(s)')
        print(f'  fallbacks : {s["n_fallbacks"]}')
        for e in s['entries']:
            print(f'    {e.get("name", "?"):<24} key={e.get("key", "?")[:12]}'
                  f'… {_mib(int(e.get("bytes", 0)))} build '
                  f'{e.get("compile_s", 0.0):.2f}s hits '
                  f'{e.get("hits", 0)} (torch {e.get("torch", "?")}, '
                  f'{e.get("platform", "?")})')
        for fb in s['fallbacks']:
            print(f'    FALLBACK {fb.get("name", "?")} '
                  f'key={fb.get("key", "?")[:12]}… {fb.get("error", "")}')
    if args.check:
        problems = []
        if s['n_fallbacks']:
            problems.append(f'{s["n_fallbacks"]} cached libraries failed '
                            f'to load and were rebuilt (see fallbacks '
                            f'above)')
        if args.min_entries and s['n_entries'] < args.min_entries:
            problems.append(f'{s["n_entries"]} entries < --min-entries '
                            f'{args.min_entries}')
        if args.min_hits and s['hits'] < args.min_hits:
            problems.append(f'{s["hits"]} recorded hits < --min-hits '
                            f'{args.min_hits}')
        if problems:
            print('torch_segwarm check FAILED: ' + '; '.join(problems),
                  file=sys.stderr)
            return 1
        print(f'torch_segwarm check OK: {s["n_entries"]} entries, '
              f'{s["hits"]} hits, 0 fallbacks')
    return 0


def cmd_clear(args) -> int:
    n = clear_cache(args.cache_dir)
    print(f'torch_segwarm: removed {n} cached file(s) under '
          f'{args.cache_dir}')
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='torch_segwarm', description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest='cmd', required=True)

    wp = sub.add_parser('warm', help='prebuild the libraries')
    wp.add_argument('--cache-dir', required=True)
    wp.add_argument('--device', default=None,
                    help='the card unless "cpu" is named (then K1 and K2 '
                         'are not built)')
    wp.add_argument('--models', default='',
                    help='comma-separated models: an engine init each '
                         '(or, with --train, a trainer)')
    wp.add_argument('--num_class', type=int, default=19)
    wp.add_argument('--compute_dtype', default=None)
    wp.add_argument('--buckets', default='512x1024',
                    help='engine mode: HxW bucket list')
    wp.add_argument('--batch', type=int, default=8,
                    help='engine mode: the buckets\' batch')
    wp.add_argument('--ckpt', default=None,
                    help='engine mode: the checkpoint the servers load')
    wp.add_argument('--train', action='store_true',
                    help='a trainer and its first train and eval step')
    wp.add_argument('--config', default=None,
                    help='--train: a saved config.json')
    wp.add_argument('--train-bs', type=int, default=16)
    wp.add_argument('--crop', type=int, default=512)

    st = sub.add_parser('stats', help='cache contents and provenance')
    st.add_argument('--cache-dir', required=True)
    st.add_argument('--json', action='store_true')
    st.add_argument('--check', action='store_true',
                    help='exit 1 on any recorded fallback (plus optional '
                         '--min-entries/--min-hits floors)')
    st.add_argument('--min-entries', type=int, default=0)
    st.add_argument('--min-hits', type=int, default=0)

    cp = sub.add_parser('clear', help='delete every cached file')
    cp.add_argument('--cache-dir', required=True)

    args = ap.parse_args(argv)
    if args.cmd == 'warm':
        return cmd_warm(args)
    if args.cmd == 'stats':
        return cmd_stats(args)
    return cmd_clear(args)


if __name__ == '__main__':
    sys.exit(main())
