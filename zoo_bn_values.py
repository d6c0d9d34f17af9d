"""How many values the train-mode BatchNorms of each zoo model see.

PERF.md predicts a model's train step and peak memory on the card from
the values its BatchNorms normalize an image at the Cityscapes training
crop. This script counts them with a forward hook on every BatchNorm of
the port's model, in training mode, on one 512x1024 image, and prints
one JSON line a model: the values and the BatchNorm layers, and the
values of its GroupNorms and LayerNorms (FPN, MixTransformer), whose
statistics are computed the same way.

    python3 zoo_bn_values.py ppliteseg cfpnet fddwnet smp-resnet18-fpn

Each argument names a model of the port's registry at its defaults
(bisenetv2 and ddrnet with their aux heads, stdc with its detail head,
as chip_smoke.py runs them), or smp-<encoder>-<decoder> for the smp hub.
Runs on the CPU; no card needed.
"""

from __future__ import annotations

import argparse
import json

import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.nn import (BatchNorm, DropoutMasks, GroupNorm,
                                LayerNorm, bind_dropout)

H, W = 512, 1024


def bn_values(name: str) -> dict:
    if name.startswith('smp-'):
        _, encoder, decoder = name.split('-')
        cfg = SegConfig(model='smp', encoder=encoder, decoder=decoder,
                        num_class=19)
    else:
        cfg = SegConfig(model=name, num_class=19,
                        use_aux=name in ('bisenetv2', 'ddrnet'),
                        use_detail_head=name == 'stdc')
    model = get_model(cfg).train()
    seen, norms = [], []
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.register_forward_hook(lambda mod, args, out:
                                seen.append(args[0].numel()))
    for m in model.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.register_forward_hook(lambda mod, args, out:
                                    norms.append(args[0].numel()))
    # a training forward; the dropout models draw their masks from a seeded
    # CPU generator
    masks = DropoutMasks(torch.Generator().manual_seed(0))
    with torch.no_grad(), bind_dropout(model, masks):
        model(torch.rand(1, H, W, 3))
    return {'model': name, 'values_per_image': sum(seen),
            'batchnorm_layers': len(layers), 'calls': len(seen),
            'group_and_layer_norm_values_per_image': sum(norms)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('models', nargs='+')
    for name in parser.parse_args().models:
        print(json.dumps(bn_values(name)), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
