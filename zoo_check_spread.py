"""How far the CPU path parts from itself in chip_smoke.py's zoo check.

chip_smoke.py holds 3 float32 train steps of each zoo model on the card
against the CPU path: the first step's loss within 1e-5 relative, every
step's within 1e-3 and the weights within 1e-3. The check can tell a card
fault from float32 rounding only where rounding alone stays well inside
those limits. This script measures that on the CPU: the same steps (3, or as
chip_smoke.ZOO_SMALL_RUN sets them) from
the zoo's seeded weights, and from those weights times (1 + 1e-7 x
standard normal noise), about one float32 rounding, and prints one JSON
line a draw with how far the two runs part (largest relative difference
of the losses, largest absolute difference of the weights).

    python3 zoo_check_spread.py liteseg:4 liteseg:16 stdc:16

Each argument names a model of chip_smoke.ZOO and the samples a step; a
model of chip_smoke.ZOO_SMALL_RUN runs at the depth and for the steps the
check cuts it to. Runs on the CPU; no card needed.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

import chip_smoke as cs
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.utils.convert import (_flatten, _nest,
                                           random_jax_variables)


DRAWS = 2


def spread(kw: dict, samples: int):
    """Yield, a draw, how far the CPU run from perturbed weights parts
    from the CPU run from the zoo's weights."""
    build = cs.zoo_small_model(kw)
    variables = random_jax_variables(
        (build or get_model)(cs._train_config('unused', **kw)), seed=1)
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
        yield {'model': kw['model'], 'samples': samples, 'draw': seed,
               'first_step_loss': cs._rel_loss(run[0][:1], ref[0][:1]),
               'all_steps_loss': cs._rel_loss(run[0], ref[0]),
               'weights': weights[0], 'weights_leaf': weights[1]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('runs', nargs='+', metavar='MODEL:SAMPLES')
    args = parser.parse_args()
    zoo = {kw['model']: kw for _, kw, _, _ in cs.ZOO}
    for item in args.runs:
        model, samples = item.split(':')
        for line in spread(zoo[model], int(samples)):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
