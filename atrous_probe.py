"""How DeepLabV3's ASPP rate convs run on one CUDA card.

    python3 atrous_probe.py

ASPP convolves the 1/8-resolution map (128x256 at a 1024x2048 eval
batch, 512 channels to 256) with 3x3 kernels at rates 12, 24 and 36. The
script times, at bs16 in bf16 (CUDA events, after warm-up), each rate's
conv three ways: cuDNN's dilated conv on the channels_last map (the
models' layout), the same on a contiguous NCHW map, and
`models/smp.py::atrous_conv` (an undilated conv over the rate x rate
phases of the map) on the channels_last map, whose result is checked
against the dilated conv's in float32. Then DeepLabV3's eval step at
1024x2048 bs16 (ResNet-18, `build_eval_step`, K1 and K2 included) with
ASPP's rate convs as the port runs them and with cuDNN's dilated conv in
their place. Prints a line a measurement, the card's name and power
limit first. Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys

import torch
import torch.nn.functional as F

B, H, W, C = 16, 1024, 2048, 19
RATES = (12, 24, 36)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print('atrous_probe: no CUDA device', file=sys.stderr)
        return 2
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.models.smp import AtrousConvBNAct, atrous_conv
    from rtseg_tpu_torch.nn import ConvBNAct
    from rtseg_tpu_torch.train import build_eval_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, 512, H // 8, W // 8), generator=g, device=dev
                    ).to(torch.bfloat16)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        for rate in RATES:
            conv = torch.nn.Conv2d(512, 256, 3, padding=rate, dilation=rate,
                                   bias=False, device=dev)
            w = conv.weight.to(torch.bfloat16)
            dilated_cl = time_ms(lambda: F.conv2d(x_cl, w, None, 1, rate,
                                                  rate), iters=2)
            dilated = time_ms(lambda: F.conv2d(x, w, None, 1, rate, rate),
                              iters=5)
            phases = time_ms(lambda: atrous_conv(x_cl, conv), iters=5)
            xs = x_cl[:2].float()
            err = float((atrous_conv(xs, conv) - F.conv2d(
                xs, conv.weight, None, 1, rate, rate)).abs().max())
            print(f'ASPP rate {rate} conv [{B},512,{H // 8},{W // 8}] -> 256 '
                  f'bf16 ({card}): cuDNN dilated on channels_last '
                  f'{dilated_cl:.3f} ms, on contiguous NCHW {dilated:.3f} ms; '
                  f'atrous_conv on channels_last {phases:.3f} ms (float32 '
                  f'largest difference from the dilated conv {err:.2e})',
                  flush=True)
            del conv, w
    del x, x_cl
    cfg = SegConfig(model='smp', encoder='resnet18', decoder='deeplabv3',
                    num_class=C, compute_dtype='bfloat16')
    model = get_model(cfg, device=dev).eval()
    imgs = torch.randn((B, H, W, 3), generator=g, device=dev)
    msks = torch.randint(0, C, (B, H, W), generator=g, device=dev)
    step = build_eval_step(cfg, model, dev)
    shipped = time_ms(lambda: step(imgs, msks), iters=3)
    phased = AtrousConvBNAct.forward
    AtrousConvBNAct.forward = ConvBNAct.forward
    try:
        dilated = time_ms(lambda: step(imgs, msks), iters=2)
    finally:
        AtrousConvBNAct.forward = phased
    print(f'DeepLabV3 (ResNet-18) eval step at {H}x{W} bs{B} bf16 ({card}): '
          f'{shipped:.3f} ms with ASPP through atrous_conv, {dilated:.3f} ms '
          f'with cuDNN\'s dilated convs', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
