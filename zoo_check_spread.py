"""How far the CPU path parts from itself in chip_smoke.py's zoo check.

chip_smoke.py holds 3 float32 train steps of each zoo model on the card
against the CPU path: the first step's loss within 1e-5 relative, every
step's within 1e-3 and the weights within 1e-3. The check can tell a card
fault from float32 rounding only where rounding alone stays well inside
those limits. This script measures that on the CPU: the same steps (3, or as
chip_smoke.ZOO_SMALL_RUN sets them) from
the zoo's seeded weights (chip_smoke.zoo_small_variables), and from those
weights times (1 + 1e-7 x
standard normal noise), about one float32 rounding, and prints one JSON
line a draw with how far the two runs part (largest relative difference
of the losses, largest absolute difference of the weights).

    python3 zoo_check_spread.py liteseg:4 liteseg:16 stdc:16
    python3 zoo_check_spread.py smp-resnet18-pan:4 kd:4
    python3 zoo_check_spread.py adam-bisenetv2:4 adamw-smp-mit_b2-fpn:4

Each argument names a model of chip_smoke.ZOO (its model name, or
smp-<encoder>-<decoder> for the smp hub's, chip_smoke.zoo_key) and the
samples a step; a model of chip_smoke.ZOO_SMALL_RUN runs at the depth and
for the steps the check cuts it to. `kd` is the KD student of
chip_smoke.phase_kd with its teacher (chip_smoke.kd_small_config, the
steps of chip_smoke.KD_SMALL). `adam-<key>` and `adamw-<key>` are the
runs of chip_smoke.OPTIM_CHECKS under that optimizer, at the schedule of
chip_smoke.OPTIM_SMALL. Runs on the CPU; no card needed.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import tempfile

import numpy as np

import chip_smoke as cs
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.utils.convert import _flatten, _nest


DRAWS = 2


def spread(kw: dict, samples: int, tmp: str):
    """Yield, a draw, how far the CPU run from perturbed weights parts
    from the CPU run from the zoo's weights."""
    if kw is None:                   # the KD student and its teacher
        build = None
        variables, teacher = cs.kd_small_variables()
        config = dict(cs.kd_small_config(cs.teacher_checkpoint(tmp,
                                                               teacher)),
                      train_bs=samples, val_bs=samples,
                      synthetic_len=cs.KD_SMALL[1] * samples)
        kw = cs.KD_STUDENT
    else:
        build = cs.zoo_small_model(kw)
        variables = cs.zoo_small_variables(
            kw, (build or get_model)(cs._train_config('unused', **kw)))
        config = cs.zoo_small_config(kw, samples)
    ref = cs._card_vs_cpu_runs(variables, ('cpu',), build, **config)['cpu']
    for seed in range(DRAWS):
        rs = np.random.RandomState(seed)
        near = _nest({k: (v * (1 + 1e-7 * rs.standard_normal(v.shape))
                          ).astype(np.float32)
                      for k, v in _flatten(variables).items()})
        run = cs._card_vs_cpu_runs(near, ('cpu',), build, **config)['cpu']
        weights = max(cs._same_weights(run[1], ref[1], math.inf),
                      cs._same_weights(run[2], ref[2], math.inf))
        yield {'model': cs.zoo_key(kw),
               'optimizer': kw.get('optimizer_type', 'sgd'),
               'samples': samples, 'draw': seed,
               'first_step_loss': cs._rel_loss(run[0][:1], ref[0][:1]),
               'all_steps_loss': cs._rel_loss(run[0], ref[0]),
               'weights': weights[0], 'weights_leaf': weights[1]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('runs', nargs='+', metavar='MODEL:SAMPLES')
    args = parser.parse_args()
    zoo = {cs.zoo_key(kw): kw for _, kw, _, _ in cs.ZOO}
    zoo['kd'] = None
    for _, kw, _ in cs.OPTIM_CHECKS:
        zoo[f"{kw['optimizer_type']}-{cs.zoo_key(kw)}"] = kw
    tmp = tempfile.mkdtemp(prefix='zoo_check_spread_')
    try:
        for item in args.runs:
            model, samples = item.split(':')
            for line in spread(zoo[model], int(samples), tmp):
                print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
