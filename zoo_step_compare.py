"""Train and eval steps of zoo models on two checkouts of the port, in
turns.

    python3 zoo_step_compare.py PARENT_DIR CHANGE_DIR [MODEL ...]

Each checkout's `chip_smoke.py` builds every named model (a name of its
`ZOO`, or BiSeNetv2: the train phase's model with its aux heads) with
`SegTrainer` from Flax's initializers, at 512x1024 bs16 bf16 with OHEM,
SGD and EMA, and times its train step on a resident batch and its eval
step (`build_eval_step` on the EMA model, K1 and K2 included) on a
resident 1024x2048 bs16 batch of the synthetic val set (CUDA events, 2
warm-up steps, mean of 5). The checkouts run in the order parent,
change, change, parent, each in a process of its own, so that a drift of
the card's clock or of the host's load shows as a difference between the
two runs of one checkout. Prints one JSON line a run, the card's name and
power limit, and a line a model with the change's time over the parent's.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

MODELS = ('BiSeNetv2', 'FastSCNN', 'DDRNet-23-slim', 'STDC1', 'ICNet',
          'PP-LiteSeg', 'CFPNet', 'ESPNet', 'DFANet', 'FDDWNet')

CODE = r'''
import json, sys, tempfile, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from rtseg_tpu_torch.train import SegTrainer, build_eval_step
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
names = json.loads(sys.argv[1])
zoo = {n: kw for n, kw, _, _ in cs.ZOO}
zoo['BiSeNetv2'] = {}
val = SegTrainer(cs._slice_config()).val_loader
eimgs, emsks = (x.cuda() for x in next(iter(val)))
out = {}
for name in names:
    cfg = cs._train_config(tempfile.mkdtemp(), synthetic_len=3 * cs.B,
                           total_epoch=1, save_ckpt=False, **zoo[name])
    t = SegTrainer(cfg)
    t.train_loader.set_epoch(0)
    imgs, msks = next(iter(t.train_loader))
    imgs, msks = imgs.cuda(), msks.cuda()
    train = cs.time_ms(lambda: t.train_step(t.state, imgs, msks),
                       iters=5, warmup=2)
    step = build_eval_step(cfg, t.ema_model, torch.device('cuda'))
    out[name] = {'train': train,
                 'eval': cs.time_ms(lambda: step(eimgs, emsks), iters=5,
                                    warmup=2)}
    del t, step
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('parent')
    parser.add_argument('change')
    parser.add_argument('models', nargs='*', default=list(MODELS))
    args = parser.parse_args()
    runs = []
    for tree in ('parent', 'change', 'change', 'parent'):
        r = subprocess.run([sys.executable, '-c', CODE,
                            json.dumps(args.models)],
                           cwd=getattr(args, tree), capture_output=True,
                           text=True, timeout=900)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append((tree, json.loads(r.stdout.strip().splitlines()[-1])))
        print(tree, json.dumps(runs[-1][1]), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for n in args.models:
        for kind in ('train', 'eval'):
            p = [r[n][kind] for t, r in runs if t == 'parent']
            c = [r[n][kind] for t, r in runs if t == 'change']
            print(f'{n} {kind}: parent {p} change {c}; change/parent '
                  f'{sum(c) / sum(p):.4f}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
