"""How many values the train-mode BatchNorms of each zoo model see.

PERF.md predicts a model's train step and peak memory on the card from
the values its BatchNorms normalize an image at the Cityscapes training
crop. This script counts them with a forward hook on every BatchNorm of
the port's model, in training mode, on one 512x1024 image, and prints
one JSON line a model: the values and the BatchNorm layers.

    python3 zoo_bn_values.py ppliteseg cfpnet fddwnet

Each argument names a model of the port's registry at its defaults
(bisenetv2 and ddrnet with their aux heads, stdc with its detail head,
as chip_smoke.py runs them). Runs on the CPU; no card needed.
"""

from __future__ import annotations

import argparse
import json

import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.nn import BatchNorm

H, W = 512, 1024


def bn_values(name: str) -> dict:
    cfg = SegConfig(model=name, num_class=19,
                    use_aux=name in ('bisenetv2', 'ddrnet'),
                    use_detail_head=name == 'stdc')
    model = get_model(cfg).train()
    seen = []
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.register_forward_hook(lambda mod, args, out:
                                seen.append(args[0].numel()))
    with torch.no_grad():
        model(torch.rand(1, H, W, 3))
    return {'model': name, 'values_per_image': sum(seen),
            'batchnorm_layers': len(layers), 'calls': len(seen)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('models', nargs='+')
    for name in parser.parse_args().models:
        print(json.dumps(bn_values(name)), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
