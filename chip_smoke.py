#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels (nvcc, sm_90a);
     count the SASS instructions of K1's row loop (cuobjdump)
  2. K1 (fused upsample+argmax) against its plain version at the slice's
     shapes, [16,128,256,19] -> 1024x2048, in float32 and bfloat16 (and
     bf16 logits against the float32 plain version), plus integer logits,
     all-equal logits, the identity size, and in float32 and bfloat16 the
     train run's validation shape [16,64,128,19] -> 512x1024, the
     1/4-resolution shape [16,256,512,19] -> 1024x2048, the output stride
     2 shapes [16,512,1024,19] -> 1024x2048 and [16,256,512,19] ->
     512x1024 (float32, bfloat16, and bfloat16 against the float32 plain
     version), W=2050,
     align_corners=False, a downsample, an odd shape, C=1, C=150
  3. K2 (confusion matrix) against its plain version, bit-equal, on four
     input families (k2_family: uniform random, the synthetic dataset's
     8x8 cells, street-like, one key) at [16,1024,2048] and [16,512,1024]
     with int32 and int64 labels, on offset views, odd n, C=1 and C=241;
     its time on each family and shape beside the bound, and its device
     time a call with the calls queued behind a sleep kernel beside the
     host's time a call
  4. the slice: SegTrainer(cfg).validate() of BiSeNetv2 (aux heads, 19
     classes, bf16) on synthetic 1024x2048 data, bs16, 3 batches, with the
     kernels' launch counts read around the run; build_predict_step once;
     and the eval step on the card against the CPU path on a small input
  5. train: SegTrainer(cfg).run() of BiSeNetv2 (aux heads, OHEM, SGD
     under OneCycle, EMA; 19 classes, bf16, 512x1024 crop, bs16) for 2
     epochs of 4 steps on synthetic data, validating the EMA weights every
     epoch and in val_best() through K1 and K2 (launch counts read around
     the run); checkpoints written, a second trainer resumes them exactly;
     the OHEM loss (bisection branch) on the card against the CPU on one
     batch's bf16 logits; K1 and K2 on the EMA model's deferred logits of
     that batch against their plain versions; 3 float32 train steps of 4
     distinct samples on the card (deterministic cuDNN) against the CPU
     path at 64x128, and the card's spread with its default algorithms; the
     train step's time, its split (forward+loss, backward,
     optimizer+EMA), the card's time by operator over two steps
     (torch.profiler), the OHEM loss alone, the peak memory, and run()'s
     wall time beside the loaders alone
  6. zoo: for FastSCNN, DDRNet-23-slim (aux head), STDC1 (detail head),
     the backbone family, BiSeNetv1, ICNet (aux heads), SwiftNet,
     FarSeeNet, ShelfNet, LinkNet (ResNet-18), LiteSeg and CANet
     (MobileNetV2), PP-LiteSeg, the InitialBlock-stem models CFPNet,
     DABNet, ERFNet, ESNet, FDDWNet, FSSNet and MiniNetv2, the ten
     models that need no new op, SQNet, EDANet, ADSCNet, ContextNet,
     FPENet, ESPNet, ESPNetv2, CGNet, RegSeg and DFANet, and the six of
     the channel shuffle, dropout and the 2x2 argmax pool, LEDNet, AGLNet,
     Lite-HRNet, ENet, MiniNet and SegNet (their dropout masks from the
     train step's generator on the card), and the smp hub's nine decoders
     on ResNet-18 (Unet, Unet++, LinkNet, FPN, MAnet, PAN, PSPNet,
     DeepLabV3, DeepLabV3+) and FPN on MiT-b2,
     SegTrainer(cfg).run() from the trainer's default (Flax) init at
     512x1024 bs16 bf16 (OHEM, SGD under OneCycle, EMA) for 1 epoch of 3
     steps with its validation and val_best() through K1 and K2 (launch
     counts read around the run: the logits of LinkNet, CANet, ERFNet,
     ESNet, FDDWNet, FSSNet, SQNet, ADSCNet, ESPNet, ENet, MiniNet, SegNet
     and smp's Unet, Unet++, LinkNet and MAnet come at full resolution, so
     they launch K1 no time and K2 once a val batch); K1
     and K2 on the EMA model's logits of the val batch against their
     plain versions; float32 train steps on the card (deterministic
     cuDNN) against the CPU path at 64x128 (128x128 for PAN; 3 steps of
     4 distinct samples, or as `ZOO` and `ZOO_SMALL_RUN` set them; the
     same dropout and drop-path masks on both, drawn on the CPU), with
     STDC's
     detail_conv (no gradient) moved by weight decay as on the CPU; the
     train step's time, split and peak memory, and the profile of the
     models new in this slice (PROFILED); the eval step at 1024x2048, its
     peak memory (a line of its own for MiT-b2), and K1, K2 timed on each
     model's logits there
  6b. KD (phase_kd): the reference README's pair, a ResNet-101 DeepLabV3+
     teacher whose run() (1 epoch of 3 steps at 512x1024 bs16 bf16, its
     validation and val_best) writes the checkpoint that a ResNet-18
     DeepLabV3+ student's run() with kd_training (KL, T 4, coefficient 1)
     loads as its frozen teacher, launch counts read around both; the
     teacher unchanged, outside the optimizer and the checkpoints; K1 and
     K2 on the student's logits; float32 KD steps card against CPU (first
     loss and loss_kd within 1e-5, weights within 1e-3); the student's
     step with and without KD, the teacher's forward alone, the student's
     eval step at 1024x2048
  6c. the optimizer tail (phase_optim): (a) smp FPN on MiT-b2 under AdamW:
     run() for 1 epoch of 3 steps at 512x1024 bs16 bf16 with its
     validation and val_best through K1 and K2 (launches counted), a
     fresh trainer resumes last.ckpt (weights, AdamW moments and counts,
     step, EMA) bit for bit and one more step from each is bit-equal
     (deterministic cuDNN), the step's time, split and peak; (b)
     BiSeNetv2 with its aux heads under Adam with remat: run() (launches
     counted); BiSeNetv2, ENet, MiT-b2 FPN and SegNet one step with and
     without remat from the same Flax init, bit-equal, the same number of
     masks drawn, both steps' times and peaks; (c) the uint8 tail:
     device_flip_norm at [16,512,1024,3] with random flags on the card
     bit-equal to the CPU and the host path, BiSeNetv2's train step with
     norm_coeffs on a uint8 batch bit-equal to the float step on the
     host-normalized batch, the eval step with norm_coeffs at 1024x2048
     (launches counted) giving the float step's confusion matrix; (d) 3
     float32 steps card against CPU under Adam (BiSeNetv2) and AdamW
     (MiT-b2 FPN) at OPTIM_SMALL's schedule, within the zoo's limits
  7. import: a random torchvision-named ResNet-18 and MobileNetV2
     state_dict, written to a temp dir, imported through
     config.backbone_ckpt by SegTrainer on the card into SwiftNet and
     LiteSeg: the backbone and its EMA hold the dict's values, every other
     leaf the Flax init
  8. times (CUDA events after warm-up) of each kernel, its plain version
     and a one-call library yardstick, beside the bound and the share of
     it reached; K1 also at the 1/4-resolution shape and at output stride
     2 [16,512,1024,19] -> 1024x2048; K1 at several class
     counts (each checked); the slice's imgs/s; K1's row loop at the
     issue rate, from its SASS (phase 1)
  9. the {"train": ...}, {"zoo": ...}, {"kd": ...}, {"optim": ...} and
     {"import": ...} lines, and the {"kernels": [...]} line, whose launch
     counts are those of the eval slice (phase 4), the train run (phase
     5), the zoo's runs (phase 6), the KD runs (phase 6b) and the
     optimizer tail's runs and eval step (phase 6c) together, checked
     exactly against the counts they give: K1 73, K2 105;
  10. the {"ok": true, ...} line.

Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

B, h, w, C = 16, 128, 256, 19          # deferred BiSeNetv2 logits
H, W = 1024, 2048                      # Cityscapes val shape
TRAIN_H, TRAIN_W = 512, 1024           # Cityscapes training crop
IGNORE = 255


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ------------------------------------------------------------------ phase 1
def phase_card_and_build():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    card = smi.stdout.strip().splitlines()[0]
    say(f'card: {card}')
    from rtseg_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build(force=True, ptxas_verbose=True)
    say(f'build: {len(logs)} kernels in {time.perf_counter() - t0:.2f} s')
    for name, log in logs.items():
        regs, spills, fn, mine = [], 0, '', None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            fn = entry.group(1) if entry else fn
            spills += sum(map(int, re.findall(r'(\d+) bytes spill stores',
                                              line)))
            used = re.search(r'Used (\d+) registers', line)
            if used:
                regs.append(int(used.group(1)))
                # K1's instance for the slice: bf16 logits, C classes
                if 'bfloat16' in fn and f'Li{C}E' in fn:
                    mine = regs[-1]
        say(f'  ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} '
            f'registers, {spills} bytes of spill stores'
            + (f'; bf16 C={C}: {mine} registers' if mine else ''))
    return card, _sass_row_loop(cuda_build)


def _sass_row_loop(cuda_build):
    """The SASS of K1's row loop in its bf16 C-class instance, read with
    cuobjdump from the built library: instructions a row and by opcode.
    The row loop is the smallest loop (a backward branch) that holds the
    argmax's FMNMX; a row is one STG. Returns None, saying why, where the
    SASS cannot be read."""
    tool = Path(cuda_build._nvcc()).with_name('cuobjdump')
    dump = subprocess.run([str(tool), '-sass',
                           str(cuda_build.library_path('fused_head'))],
                          capture_output=True, text=True, timeout=120)
    body = None
    for part in re.split(r'\n\s*Function : ', dump.stdout)[1:]:
        name = part.split(None, 1)[0]
        if 'head_argmax_kernel' in name and 'bfloat16' in name and \
                f'Li{C}E' in name:
            body = part
    if dump.returncode != 0 or body is None:
        say(f'SASS: not read (cuobjdump exit {dump.returncode}, '
            f'instance found: {body is not None}) {dump.stderr[-300:]}')
        return None
    ins, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r'\s*(\.L_x_\d+):', line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r'\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?'
                     r'([A-Z][A-Z0-9_.]*)([^;]*);', line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        labels.update((lb, addr) for lb in pending)
        pending = []
        op = m.group(2).split('.')[0]
        target = None
        if op == 'BRA':
            t = re.search(r'0x([0-9a-f]+)|(\.L_x_\d+)', m.group(3))
            target = (int(t.group(1), 16) if t.group(1) else t.group(2)) \
                if t else None
        ins.append((addr, op, target))
    loops = []
    for addr, op, target in ins:
        start = labels.get(target, target)
        if op == 'BRA' and isinstance(start, int) and start < addr:
            ops = [o for a, o, _ in ins if start <= a <= addr and o != 'NOP']
            if 'FMNMX' in ops and 'STG' in ops:
                loops.append(ops)
    if not loops:
        say(f'SASS: no row loop found among {len(ins)} instructions')
        return None
    ops = min(loops, key=len)
    rows = ops.count('STG')
    hist = {o: ops.count(o) / rows for o in sorted(set(ops), key=ops.count,
                                                   reverse=True)}
    out = {'instructions_per_row': len(ops) / rows, 'rows_per_pass': rows,
           'by_opcode_per_row': hist}
    say(f'SASS: K1 bf16 C={C} row loop: {len(ops) / rows:g} instructions a '
        f'row ({rows} rows a pass): '
        + ', '.join(f'{o} {n:g}' for o, n in hist.items()))
    return out


# ------------------------------------------------------------------ phase 2
def _logit_gap(x: torch.Tensor, pred: torch.Tensor) -> float:
    """Largest shortfall, in float32 logits upsampled the plain way, of the
    class a head picked against the true maximum (0 where it is the max)."""
    from rtseg_tpu_torch.ops.resize import resize_bilinear
    up = resize_bilinear(x.float(), (pred.shape[1], pred.shape[2]))
    best = up.max(dim=-1).values
    got = up.gather(-1, pred.long().unsqueeze(-1)).squeeze(-1)
    return float((best - got).max())


def _rate(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got != want).float().mean())


def phase_k1(dev):
    from rtseg_tpu_torch.ops.fused_head import _argmax_ref, resize_argmax
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    x = torch.randn((B, h, w, C), generator=g, device=dev)
    xb = x.to(torch.bfloat16)
    for name, xin, tol in (('float32', x, 1e-4), ('bfloat16', xb, 8e-3)):
        got = resize_argmax(xin, (H, W))
        ref = _argmax_ref(xin, (H, W))
        torch.cuda.synchronize()
        check(got.shape == (B, H, W) and got.dtype == torch.int32,
              f'K1 {name}: output {tuple(got.shape)} {got.dtype}')
        rate = _rate(got, ref)
        gap = _logit_gap(xin, got)
        say(f'K1 {name} random logits: mismatch {rate:.3e} (tolerance '
            f'{tol:g}), max logit gap at the chosen class {gap:.3e}')
        check(rate <= tol, f'K1 {name} mismatch {rate} > {tol}')
        out[name] = (rate, gap)
    # the kernel computes in float32 on bf16 logits: it meets the float32
    # limit against the plain version run on the same values in float32
    rate = _rate(resize_argmax(xb, (H, W)), _argmax_ref(xb.float(), (H, W)))
    say(f'K1 bfloat16 logits against the float32 plain version: mismatch '
        f'{rate:.3e} (tolerance 1e-4)')
    check(rate <= 1e-4, f'K1 bfloat16 vs float32 plain mismatch {rate}')
    out['bfloat16_vs_float32'] = rate
    xi = torch.randint(-8, 8, (B, h, w, C), generator=g, device=dev
                       ).float() * 4.0
    rate = _rate(resize_argmax(xi, (H, W)), _argmax_ref(xi, (H, W)))
    say(f'K1 integer logits: mismatch {rate:.3e} (tolerance 1e-4)')
    check(rate <= 1e-4, f'K1 integer-logit mismatch {rate}')
    zeros = torch.zeros((2, h, w, C), device=dev)
    check(bool((resize_argmax(zeros, (H, W)) == 0).all()),
          'K1 all-equal logits do not give class 0')
    say('K1 all-equal logits: class 0 everywhere')
    check(torch.equal(resize_argmax(x, (h, w)),
                      torch.argmax(x, -1).to(torch.int32)),
          'K1 identity size differs from argmax')
    say('K1 identity size: equal to argmax')
    # output stride 2 (MiniNetv2's logits): the eval shape and the train
    # run's validation shape, float32 and bfloat16 each against the plain
    # version on the same values, and bfloat16 against the float32 plain
    # version
    for shape, size in (((B, H // 2, W // 2, C), (H, W)),
                        ((B, TRAIN_H // 2, TRAIN_W // 2, C),
                         (TRAIN_H, TRAIN_W))):
        xh = torch.randn(shape, generator=g, device=dev)
        for name, xin, want, tol in (
                ('float32', xh, xh, 1e-4),
                ('bfloat16', xh.to(torch.bfloat16), xh.to(torch.bfloat16),
                 8e-3),
                ('bfloat16 against the float32 plain version',
                 xh.to(torch.bfloat16), xh.to(torch.bfloat16).float(),
                 1e-4)):
            rate = _rate(resize_argmax(xin, size), _argmax_ref(want, size))
            say(f'K1 output stride 2 {list(shape)}->{size} {name}: mismatch '
                f'{rate:.3e} (tolerance {tol:g})')
            check(rate <= tol, f'K1 stride 2 {shape} {name} mismatch {rate}')
            out[f'stride2_{shape[1]}_{name.split()[0]}'] = rate
        del xh
    xs = x[:2].contiguous()
    for name, xin, size, corners in (
            (f'train run validation [{B},{TRAIN_H // 8},{TRAIN_W // 8},{C}]'
             f'->({TRAIN_H},{TRAIN_W})', (B, TRAIN_H // 8, TRAIN_W // 8, C),
             (TRAIN_H, TRAIN_W), True),
            (f'1/4 resolution [{B},{H // 4},{W // 4},{C}]->({H},{W})',
             (B, H // 4, W // 4, C), (H, W), True),
            ('W=2050', xs, (H, 2050), True),
            ('align_corners=False', xs, (H, W), False),
            ('downsample [2,128,256,19]->(64,100)', xs, (64, 100), True),
            ('odd [1,10,13,6]->(37,53)', (1, 10, 13, 6), (37, 53), True),
            ('C=1 [2,16,32,1]->(128,256)', (2, 16, 32, 1), (128, 256), True),
            ('C=150 [2,32,64,150]->(256,512), above the register buckets',
             (2, 32, 64, 150), (256, 512), True)):
        if isinstance(xin, tuple):
            xin = torch.randn(xin, generator=g, device=dev)
        # bf16 logits against the float32 plain version on the same values
        for dtype in (torch.float32, torch.bfloat16):
            xd = xin.to(dtype)
            got = resize_argmax(xd, size, corners)
            rate = _rate(got, _argmax_ref(xd.float(), size, corners))
            say(f'K1 {name} {str(dtype)[6:]}: mismatch {rate:.3e} '
                f'(tolerance 1e-4)')
            check(rate <= 1e-4, f'K1 {name} {dtype} mismatch {rate}')
            if xin.shape[-1] == 1:
                check(bool((got == 0).all()),
                      'K1 C=1 gives a class other than 0')
    torch.cuda.synchronize()
    return out


# ------------------------------------------------------------------ phase 3
K2_SHAPES = ((B, H, W), (B, TRAIN_H, TRAIN_W))
K2_FAMILIES = ('uniform', 'synthetic', 'street', 'one_key')
STREET_SHARES = (0.37, 0.23, 0.16, 0.07, 0.06, 0.04)


def k2_family(family, shape, dev, seed=1, num_class=C):
    """(preds, labels) int32 on the card, made from `seed`:
    'uniform' random labels and predictions with ignored (10%) and
    out-of-range values; 'synthetic' the synthetic dataset's 8x8 cells of
    uniform classes, predictions right on 90% of the cells; 'street' a
    class field at 1/32 resolution (32x64 cells at 1024x2048) upsampled
    nearest, classes drawn with a street-scene skew (STREET_SHARES on six
    classes, the remaining 0.07 even over the others), about 10% ignored
    (the bottom 1/16 of the rows and 5% of the cells), predictions right
    on 90% of the cells and another class on the rest; 'one_key' class 0
    labels and predictions everywhere."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, hh, ww = shape
    if family == 'uniform':
        preds = torch.randint(0, num_class + 2, shape, generator=g,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(-1, num_class + 2, shape, generator=g,
                               device=dev, dtype=torch.int32)
        drop = torch.rand(shape, generator=g, device=dev) < 0.1
        return preds, torch.where(drop, torch.full_like(labels, IGNORE),
                                  labels)
    if family == 'one_key':
        zeros = torch.zeros(shape, dtype=torch.int32, device=dev)
        return zeros, zeros.clone()
    cell = 8 if family == 'synthetic' else 32
    field = (b, hh // cell, ww // cell)
    if family == 'synthetic':
        lab = torch.randint(0, num_class, field, generator=g, device=dev)
    else:
        rest = (1 - sum(STREET_SHARES)) / (num_class - len(STREET_SHARES))
        shares = torch.tensor(list(STREET_SHARES) + [rest] * (
            num_class - len(STREET_SHARES)), device=dev)
        lab = torch.multinomial(shares, math.prod(field), replacement=True,
                                generator=g).reshape(field)
    other = (lab + torch.randint(1, num_class, field, generator=g,
                                 device=dev)) % num_class
    pred = torch.where(torch.rand(field, generator=g, device=dev) < 0.1,
                       other, lab)
    if family == 'street':
        lab = torch.where(torch.rand(field, generator=g, device=dev) < 0.05,
                          torch.full_like(lab, IGNORE), lab)
        lab[:, -max(1, field[1] // 16):] = IGNORE
    up = lambda a: a.repeat_interleave(cell, 1).repeat_interleave(
        cell, 2).to(torch.int32).contiguous()
    return up(pred), up(lab)


def _offset_view(x, offset):
    """x's pixels as a contiguous 1-D view that starts `offset` int32
    elements into its storage."""
    flat = x.reshape(-1)
    base = torch.empty(flat.numel() + offset, dtype=flat.dtype,
                       device=flat.device)
    base[offset:] = flat
    return base[offset:]


def queued_ms(fn, iters=50):
    """(device ms a call, host ms a call, queued) of `fn`: its calls are
    queued behind a long sleep kernel, so the events around them time the
    card alone; the host's time is the wall time to queue them. `queued`
    says the card had not reached the first call when the last was
    queued."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)              # about 50 ms at 2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    queued = not start.query()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host, queued


def phase_k2(dev):
    """K2 bit-equal to its plain version on the input families at both
    shapes (int32 and int64 labels), on offset views (the same offset:
    a scalar head; other offsets: scalar loads throughout), on odd n, at
    C=1 and C=241 and on one cell past 2^24; then its time on each family
    and shape beside the bound, and its device time a call with the calls
    queued behind a long kernel, beside the host's time a call."""
    from rtseg_tpu_torch.ops.pallas_metrics import (confusion_matrix_pallas,
                                                    confusion_matrix_plain)

    def same(preds, labels, what, num_class=C):
        got = confusion_matrix_pallas(preds, labels, num_class, IGNORE)
        ref = confusion_matrix_plain(preds, labels, num_class, IGNORE)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and
              got.shape == (num_class, num_class),
              f'K2 output {got.dtype} {tuple(got.shape)} ({what})')
        err = int((got.long() - ref.long()).abs().max())
        check(torch.equal(got, ref), f'K2 differs from bincount ({what}): '
                                     f'max abs {err}')
        errs.append(err)
        return int(got.sum())

    errs = []

    table = {}
    for shape in K2_SHAPES:
        n = math.prod(shape)
        bound, by = bound_ms(n * 8, n)
        for family in K2_FAMILIES:
            preds, labels = k2_family(family, shape, dev)
            total = same(preds, labels, f'{family} {shape}')
            same(preds, labels.long(), f'{family} {shape} int64 labels')
            edges = family in ('uniform', 'street')
            if edges:
                for po in (1, 3):
                    same(_offset_view(preds, po), _offset_view(labels, 1),
                         f'{family} {shape} views at offsets {po} and 1')
                same(preds.reshape(-1)[:n - 7], labels.reshape(-1)[:n - 7],
                     f'{family} {shape} n - 7')
            ms = time_ms(
                lambda: confusion_matrix_pallas(preds, labels, C, IGNORE))
            table.setdefault(family, {})[f'{shape[1]}x{shape[2]}'] = {
                'ms': ms, 'bound_ms': bound,
                'bound_by': by, 'share_of_bound': bound / ms,
                'counted': total}
            say(f'K2 {family} [{shape[0]},{shape[1]},{shape[2]}]: bit-equal '
                f'(int32, int64 labels{", views, odd n" if edges else ""}), '
                f'{total} counted; {ms:.4f} ms, {bound / ms:.1%} of the '
                f'{bound:.4f} ms bound ({by})')
            del preds, labels
    g = torch.Generator(device=dev).manual_seed(3)
    shape = K2_SHAPES[0]
    for num_class in (1, 241):
        preds = torch.randint(0, num_class + 3, shape, generator=g,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(-1, num_class + 3, shape, generator=g,
                               device=dev, dtype=torch.int32)
        total = same(preds, labels, f'C={num_class}', num_class)
        say(f'K2 C={num_class} {list(shape)}: bit-equal, {total} counted')
    del preds, labels
    one = torch.zeros(shape, dtype=torch.int32, device=dev)
    got = confusion_matrix_pallas(one, one, C, IGNORE)
    check(int(got[0, 0]) == one.numel() > 2 ** 24,
          f'K2 cell count {int(got[0, 0])} != {one.numel()}')
    say(f'K2 one cell of {int(got[0, 0])} > 2^24 counts: bit-equal')
    # the card's time a call alone, and the host's
    device = {}
    for family in ('uniform', 'street'):
        for shape in K2_SHAPES:
            preds, labels = k2_family(family, shape, dev)
            dev_ms, host_ms, queued = queued_ms(
                lambda: confusion_matrix_pallas(preds, labels, C, IGNORE))
            key = f'{family} {shape[1]}x{shape[2]}'
            device[key] = {'device_ms': dev_ms, 'host_ms': host_ms,
                           'queued': queued}
            say(f'K2 {key}: device {dev_ms:.4f} ms a call with the calls '
                f'queued behind a sleep kernel (queued: {queued}); the '
                f'host {host_ms:.4f} ms a call to queue one')
            del preds, labels
    return max(errs), {'families': table, 'device': device}


# ------------------------------------------------------------------ phase 4
def _slice_config(**kw):
    from rtseg_tpu_torch.config import SegConfig
    base = dict(model='bisenetv2', use_aux=True, num_class=C,
                dataset='synthetic', crop_h=H, crop_w=W, val_bs=B,
                synthetic_len=4 * 3 * B,          # val split: 3 batches
                compute_dtype='bfloat16', random_seed=1, load_ckpt=False)
    base.update(kw)
    return SegConfig(**base)


def phase_slice(dev):
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.ops.fused_head import resize_argmax
    from rtseg_tpu_torch.ops.pallas_metrics import confusion_matrix_pallas
    from rtseg_tpu_torch.train import SegTrainer, build_predict_step
    from rtseg_tpu_torch.utils.convert import random_jax_variables

    cfg = _slice_config()
    variables = random_jax_variables(get_model(cfg), seed=cfg.random_seed)
    trainer = SegTrainer(cfg, variables=variables)
    n_batches = len(trainer.val_loader)
    check(n_batches >= 3, f'only {n_batches} val batches')
    # count the valid pixels on a serial pass of the loader, which also
    # times the host's data alone against validate() on loader threads
    loader = trainer.val_loader
    threads, loader.workers = loader.workers, 0
    t0 = time.perf_counter()
    valid = sum(int(((m != IGNORE) & (m >= 0) & (m < C)).sum())
                for _, m in loader)
    serial_s = time.perf_counter() - t0
    loader.workers = threads

    resize_argmax.launches = 0
    confusion_matrix_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    miou = trainer.validate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'resize_argmax': resize_argmax.launches,
                'confusion_matrix': confusion_matrix_pallas.launches}
    say(f'slice: BiSeNetv2 bf16 eval, {n_batches} batches of {B}x{H}x{W}: '
        f'mIoU {miou:.6f}, cm sum {int(trainer.last_cm.sum())} of {valid} '
        f'valid px, {wall:.3f} s ({n_batches * B / wall:.2f} imgs/s incl. '
        f'host data; the serial loader alone took {serial_s:.3f} s, '
        f'validate() uses {threads} loader threads), launches {launches}')
    check(math.isfinite(miou), 'mIoU is not finite')
    check(int(trainer.last_cm.sum()) == valid,
          'confusion-matrix sum != valid pixels')
    check(all(v == n_batches for v in launches.values()),
          f'launch counts {launches} != {n_batches} batches')

    imgs, msks = next(iter(trainer.val_loader))
    imgs, msks = imgs.to(dev), msks.to(dev)
    before = resize_argmax.launches
    predict = build_predict_step(cfg, trainer.model, dev)
    preds = predict(imgs)
    torch.cuda.synchronize()
    check(preds.shape == (B, H, W) and preds.dtype == torch.int32,
          f'predict output {tuple(preds.shape)} {preds.dtype}')
    check(resize_argmax.launches == before + 1,
          'build_predict_step did not launch K1')
    say(f'predict step: {tuple(preds.shape)} int32, K1 launched')

    # the card's path (kernels, fp32) against the CPU path (plain versions,
    # which the CPU tests hold to the JAX package) on a small input
    small = dict(crop_h=64, crop_w=128, train_bs=2, val_bs=2,
                 synthetic_len=8, compute_dtype='float32')
    cms = {}
    for d in ('cuda', 'cpu'):
        t = SegTrainer(_slice_config(**small), device=d, variables=variables)
        t.validate()
        cms[d] = t.last_cm
    diff = int(np.abs(cms['cuda'] - cms['cpu']).sum())
    px = int(cms['cpu'].sum())
    say(f'small fp32 eval, card vs CPU: |cm diff| {diff} of {px} px '
        f'(tolerance {2e-4 * px:.1f})')
    check(diff <= 2e-4 * px, 'card and CPU confusion matrices differ')
    return trainer, imgs, msks, preds, launches, wall


# ------------------------------------------------------------------ phase 5
def _train_config(save_dir, **kw):
    from rtseg_tpu_torch.config import SegConfig
    base = dict(model='bisenetv2', use_aux=True, num_class=C,
                dataset='synthetic', crop_h=TRAIN_H, crop_w=TRAIN_W,
                train_bs=B, val_bs=B,
                synthetic_len=4 * B,      # 4 steps an epoch, 1 val batch
                total_epoch=2, warmup_epochs=1, lr_policy='cos_warmup',
                optimizer_type='sgd', loss_type='ohem', use_ema=True,
                compute_dtype='bfloat16', use_tb=False, use_obs=False,
                save_dir=str(save_dir), random_seed=1)
    base.update(kw)
    return SegConfig(**base)


def _same_weights(a, b, tol: float = 0.0, path: str = ''):
    """(largest |a - b|, its leaf) over two Flax-shaped variable trees;
    fails where a leaf is not within tol as np.allclose(atol=tol,
    rtol=tol) reads it (tol 0: equal; tol inf: no check)."""
    worst = (0.0, '')
    for k, v in a.items():
        name = f'{path}/{k}'
        if isinstance(v, dict):
            worst = max(worst, _same_weights(v, b[k], tol, name))
            continue
        x, y = np.asarray(v), np.asarray(b[k])
        check(tol == math.inf or np.allclose(x, y, atol=tol, rtol=tol),
              f'{name} differs by {np.abs(x - y).max()} (tolerance {tol})')
        worst = max(worst, (float(np.abs(x - y).max()), name))
    return worst


def cpu_dropout_masks(config, step: int):
    """The dropout mask source of a card-against-CPU run's step: masks
    drawn from a CPU generator seeded as the train step seeds its own
    (the card's generator draws other masks than the CPU's), which the
    dropout modules copy to the card."""
    from rtseg_tpu_torch.nn import DropoutMasks
    from rtseg_tpu_torch.train.step import dropout_seed
    return DropoutMasks(torch.Generator().manual_seed(
        dropout_seed(config.random_seed, step)))


def _card_vs_cpu_runs(variables, devices, build=None, **kw):
    """{device: (losses, Flax-shaped weights, EMA weights)} of 3 float32
    train steps at 64x128, bs 4 unless `kw` sets them (the first epoch of
    the train loader: 12 distinct synthetic samples) from the same
    weights, on each of
    `devices` ('cuda', 'cpu', or 'cuda default' for the card with cuDNN's
    default algorithms; the others run its deterministic ones), with the
    same dropout masks on each (`cpu_dropout_masks`). `build`, where
    given, makes the trainer's model in place of the registry."""
    from rtseg_tpu_torch.train import SegTrainer, build_train_step
    from rtseg_tpu_torch.train import trainer as trainer_mod
    from rtseg_tpu_torch.utils.convert import to_jax_variables
    small = dict(crop_h=64, crop_w=128, train_bs=4, val_bs=4,
                 synthetic_len=12, compute_dtype='float32', save_ckpt=False,
                 load_ckpt=False)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    for d in devices:
        torch.backends.cudnn.deterministic = d != 'cuda default'
        dev = d.split()[0]
        registry = trainer_mod.get_model
        trainer_mod.get_model = build or registry
        try:
            t = SegTrainer(_train_config('unused', **{**small, **kw}),
                           device=dev, variables=variables)
        finally:
            trainer_mod.get_model = registry
        # the same dropout masks on every device: drawn on the CPU
        t.train_step = build_train_step(
            t.config, dropout_masks=lambda k: cpu_dropout_masks(t.config, k),
            teacher=t.teacher)
        t.train_loader.set_epoch(0)
        losses = []
        for imgs, msks in t.train_loader:
            _, m = t.train_step(t.state, imgs.to(dev), msks.to(dev))
            losses.append({k: float(v) for k, v in m.items()})
        steps = t.config.synthetic_len // t.config.train_bs
        check(len(losses) == steps, f'{len(losses)} small train steps, '
              f'not {steps}')
        runs[d] = (losses, to_jax_variables(t.model),
                   to_jax_variables(t.ema_model))
    torch.backends.cudnn.deterministic = deterministic
    return runs


def _rel_loss(a, b) -> float:
    """Largest relative difference of two runs' per-step metrics."""
    return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b) for k in y)


def _train_card_vs_cpu(variables):
    """BiSeNetv2's 3 steps on the card (TF32 off) and on the CPU path with
    cuDNN's deterministic algorithms. Rounding differences grow most in
    the third step, the first at the peak LR, so a card run with the
    default algorithms, which reduce in no fixed order, can move by
    several 1e-4 from one run to the next; that run is made too, and its
    distance from the deterministic one printed, not checked."""
    runs = _card_vs_cpu_runs(variables, ('cuda', 'cpu', 'cuda default'))
    rel = _rel_loss(runs['cuda'][0], runs['cpu'][0])
    check(rel <= 1e-3, f'card vs CPU train losses differ by {rel}')
    dw = _same_weights(runs['cuda'][1], runs['cpu'][1], 1e-3)
    de = _same_weights(runs['cuda'][2], runs['cpu'][2], 1e-3)
    spread = _same_weights(runs['cuda default'][1], runs['cuda'][1],
                           math.inf)
    say(f'small fp32 train, card (deterministic cuDNN) vs CPU, 3 steps of '
        f'4 distinct samples: losses '
        f'{[m["loss"] for m in runs["cuda"][0]]} vs '
        f'{[m["loss"] for m in runs["cpu"][0]]} (largest relative '
        f'difference {rel:.2e}, tolerance 1e-3); params+BN statistics '
        f'differ by at most {dw[0]:.2e} ({dw[1]}), EMA by {de[0]:.2e} '
        f'({de[1]}); tolerance 1e-3 absolute and relative. The card with '
        f'cuDNN\'s default algorithms: params+BN statistics {spread[0]:.2e} '
        f'({spread[1]}) from its deterministic run (not checked)')
    return rel, max(dw, de)[0], spread[0]


def _profile_step(step, state, imgs, msks, n: int = 2, label='train'):
    """torch.profiler over n train steps: the card's time by operator
    (self time of the kernels each launched), the 12 largest, and the
    share of the steps' wall that the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, imgs, msks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [(e.self_device_time_total / 1e3 / n, e.count // n, e.key)
           for e in prof.key_averages()
           if e.self_device_time_total > 0 and e.device_type.name == 'CPU']
    total = sum(t for t, _, _ in ops)
    check(total > 0, 'the profiler saw no device time')
    ops.sort(reverse=True)
    say(f'{label} step profile ({n} steps, torch.profiler): card busy '
        f'{total:.3f} ms a step of {wall_ms / n:.3f} ms wall; by operator '
        f'(self device ms a step, calls a step): '
        + '; '.join(f'{k} {t:.3f} ({c})' for t, c, k in ops[:12]))
    return {'device_ms': total, 'wall_ms': wall_ms / n,
            'top': [[k, t, c] for t, c, k in ops[:12]]}


def _step_times(trainer, cfg, imgs, msks):
    """The train step on a resident batch: its ms, the split (forward+loss,
    backward, optimizer+EMA; one event each, after a synchronise), the
    peak memory of a step and the memory allocated before it."""
    from rtseg_tpu_torch.nn import DropoutMasks, bind_dropout
    from rtseg_tpu_torch.train.optim import set_hparams
    from rtseg_tpu_torch.train.state import ema_update
    from rtseg_tpu_torch.train.step import _make_forward_loss
    st, step = trainer.state, trainer.train_step
    masks = DropoutMasks(torch.Generator(device=imgs.device).manual_seed(0))
    forward_loss = _make_forward_loss(cfg, trainer.teacher)
    step_ms = time_ms(lambda: step(st, imgs, msks), iters=5, warmup=2)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(st, imgs, msks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = np.zeros(3)
    iters = 5
    for i in range(iters + 2):
        st.model.train()
        set_hparams(st.optimizer, 1e-3, 0.9)
        st.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        with bind_dropout(st.model, masks):
            loss, _ = forward_loss(st.model, imgs, msks)
        ev[1].record()
        loss.backward()
        ev[2].record()
        st.optimizer.step()
        ema_update(st.model, st.ema_model, 0.5)
        ev[3].record()
        torch.cuda.synchronize()
        if i >= 2:
            parts += [ev[j].elapsed_time(ev[j + 1]) for j in range(3)]
    st.model.eval()
    return step_ms, parts / iters, peak, before


def phase_train(dev, card):
    """SegTrainer(cfg).run() on the card, its checks, and its times."""
    from rtseg_tpu_torch.losses import ohem_cross_entropy
    from rtseg_tpu_torch.losses import losses as loss_mod
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.ops.fused_head import _argmax_ref, resize_argmax
    from rtseg_tpu_torch.ops.pallas_metrics import (confusion_matrix_pallas,
                                                    confusion_matrix_plain)
    from rtseg_tpu_torch.train import SegTrainer
    from rtseg_tpu_torch.utils.convert import (random_jax_variables,
                                               to_jax_variables)

    tmp = tempfile.mkdtemp(prefix='chip_smoke_train_')
    try:
        cfg = _train_config(tmp)
        variables = random_jax_variables(get_model(cfg), seed=1)
        trainer = SegTrainer(cfg, variables=variables)
        n_steps = cfg.total_epoch * len(trainer.train_loader)
        n_val = len(trainer.val_loader)
        check(n_val >= 1, f'{n_val} val batches')
        resize_argmax.launches = 0
        confusion_matrix_pallas.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {'resize_argmax': resize_argmax.launches,
                    'confusion_matrix': confusion_matrix_pallas.launches}
        losses = trainer.epoch_losses
        say(f'train: BiSeNetv2 bf16, aux heads + OHEM, SGD cos_warmup, EMA; '
            f'{cfg.total_epoch} epochs x {len(trainer.train_loader)} steps of '
            f'{B}x{TRAIN_H}x{TRAIN_W}; run() {wall:.3f} s; epoch losses '
            f'{losses}; step {trainer.state.step}; val_best mIoU '
            f'{miou:.6f}; launches {launches} for {3 * n_val} val batches')
        check(len(losses) == cfg.total_epoch
              and all(math.isfinite(x) for x in losses),
              f'epoch losses {losses}')
        check(trainer.state.step == n_steps == 8,
              f'step {trainer.state.step} != {n_steps}')
        check(math.isfinite(miou), 'val_best mIoU is not finite')
        # two epochs' validations and val_best's, one batch each
        check(all(v == 3 * n_val for v in launches.values()),
              f'launch counts {launches} != {3 * n_val} val batches')
        for name in ('best.ckpt', 'last.ckpt'):
            check((Path(tmp) / name / 'meta.json').exists()
                  and (Path(tmp) / name / 'state.pt').exists(),
                  f'{name} not written')

        resumed = SegTrainer(_train_config(tmp))
        check(resumed.cur_epoch == cfg.total_epoch
              and resumed.state.step == trainer.state.step,
              f'resumed at epoch {resumed.cur_epoch}, step '
              f'{resumed.state.step}')
        _same_weights(to_jax_variables(resumed.model),
                      to_jax_variables(trainer.model))
        # trainer's EMA model holds best's weights since val_best();
        # last.ckpt holds the EMA of the last step
        last = torch.load(Path(tmp) / 'last.ckpt' / 'state.pt',
                          weights_only=True)
        _same_weights(to_jax_variables(resumed.ema_model),
                      last['ema_variables'])
        bufs = {n: trainer.state.optimizer.state[p]['momentum_buffer']
                for n, p in trainer.model.named_parameters()}
        for n, p in resumed.model.named_parameters():
            check(torch.equal(resumed.state.optimizer.state[p]
                              ['momentum_buffer'], bufs[n]),
                  f'momentum of {n} not restored')
        say(f'resume: epoch {resumed.cur_epoch}, step {resumed.state.step}, '
            f'params, BN statistics, EMA and momentum restored exactly')
        del resumed
        # the same run again in this process, from a fresh trainer: the
        # first run paid for loading the backward's kernels and choosing
        # the convolutions' algorithms
        shutil.rmtree(tmp)
        again = SegTrainer(_train_config(tmp), variables=variables)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again.run()
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
        say(f'train run() again: epoch losses {again.epoch_losses}')
        del again
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the OHEM loss on the card's bf16 logits of one train batch (above
    # 2^18 pixels: the bisection branch) against the CPU on the same values
    trainer.train_loader.set_epoch(0)
    imgs, msks = next(iter(trainer.train_loader))
    imgs, msks = imgs.to(dev), msks.to(dev)
    check(msks.numel() > loss_mod._OHEM_SORT_LIMIT, 'not the bisection')
    with torch.inference_mode():
        logits = trainer.ema_model(imgs.to(torch.bfloat16))
        card_loss = float(ohem_cross_entropy(logits, msks))
        cpu_loss = float(ohem_cross_entropy(logits.cpu(), msks.cpu()))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    say(f'OHEM on bf16 logits {tuple(logits.shape)} ({msks.numel()} px, '
        f'bisection): card {card_loss:.7f}, CPU {cpu_loss:.7f}, relative '
        f'difference {rel:.2e} (tolerance 1e-4)')
    check(rel <= 1e-4, f'OHEM card vs CPU {rel}')
    ohem_check = rel

    # K1 and K2 at the shapes of the run's validation, on the EMA model's
    # deferred bf16 logits of that batch, against their plain versions
    with torch.inference_mode():
        low = trainer.ema_model(imgs.to(torch.bfloat16),
                                defer_upsample=True).contiguous()
    check(tuple(low.shape) == (B, TRAIN_H // 8, TRAIN_W // 8, C),
          f'deferred logits {tuple(low.shape)}')
    preds = resize_argmax(low, (TRAIN_H, TRAIN_W))
    k1_rate = _rate(preds, _argmax_ref(low.float(), (TRAIN_H, TRAIN_W)))
    cm = confusion_matrix_pallas(preds, msks, C, IGNORE)
    k2_equal = torch.equal(cm, confusion_matrix_plain(preds, msks, C, IGNORE))
    say(f'K1 on the EMA model\'s bf16 logits {tuple(low.shape)} -> '
        f'{TRAIN_H}x{TRAIN_W}: mismatch {k1_rate:.3e} against the float32 '
        f'plain version (tolerance 1e-4); K2 on those predictions and the '
        f'batch\'s labels: bit-equal {k2_equal}, total {int(cm.sum())}')
    check(k1_rate <= 1e-4, f'K1 train-run shape mismatch {k1_rate}')
    check(k2_equal, 'K2 differs from its plain version at the train shape')
    del low, preds

    train_rel, train_abs, train_spread = _train_card_vs_cpu(variables)

    # times on a resident batch
    step_ms, parts, peak, before = _step_times(trainer, cfg, imgs, msks)
    st, step = trainer.state, trainer.train_step
    profile = _profile_step(step, st, imgs, msks)
    ohem_ms = time_ms(lambda: ohem_cross_entropy(logits, msks), iters=10)
    eval_ms = time_ms(lambda: trainer.eval_step(imgs, msks), iters=5)
    # the host's data alone: the loaders as run() used them
    t0 = time.perf_counter()
    for epoch in range(cfg.total_epoch):
        trainer.train_loader.set_epoch(epoch)
        for _ in trainer.train_loader:
            pass
    for _ in range(3):
        for _ in trainer.val_loader:
            pass
    data_s = time.perf_counter() - t0
    busy = (n_steps * step_ms + 3 * n_val * eval_ms) / (wall * 1e3)
    say(f'train times ({card}): step on a resident batch {step_ms:.3f} ms '
        f'= {B / step_ms * 1e3:.2f} imgs/s; split forward+loss '
        f'{parts[0]:.3f} ms, backward {parts[1]:.3f} ms, optimizer+EMA '
        f'{parts[2]:.3f} ms; OHEM loss alone {ohem_ms:.3f} ms; eval step '
        f'at {TRAIN_H}x{TRAIN_W} {eval_ms:.3f} ms; peak memory of a step '
        f'{peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB allocated before '
        f'it)')
    say(f'train run() {wall:.3f} s with host data (the same run again in '
        f'this process {warm_wall:.3f} s); the loaders alone (same batches, '
        f'{cfg.base_workers} threads) {data_s:.3f} s; card busy about '
        f'{busy:.3f} of the first run\'s wall time and '
        f'{busy * wall / warm_wall:.3f} of the second\'s ({n_steps} steps x '
        f'step time + {3 * n_val} val batches x eval step time, over the '
        f'wall)')
    return launches, {'step_ms': step_ms, 'parts_ms': parts.tolist(),
                      'ohem_ms': ohem_ms, 'peak_bytes': peak, 'wall_s': wall,
                      'warm_wall_s': warm_wall, 'profile': profile,
                      'ohem_card_vs_cpu': ohem_check,
                      'card_vs_cpu_loss': train_rel,
                      'card_vs_cpu_weights': train_abs,
                      'card_default_vs_deterministic': train_spread}


# ------------------------------------------------------------------ phase 6
# (model name, config switches, output stride of its deferred logits: 1
# for the models that end at full resolution, samples a step of its
# card-against-CPU train run). FastSCNN, DDRNet and STDC port the TPU
# configs of BASELINE.json #0 and #2; the others run at the JAX registry's
# defaults: the backbone family on ResNet-18, or MobileNetV2 for LiteSeg
# and CANet; PP-LiteSeg on its own STDC1; the InitialBlock-stem models,
# MiniNetv2's logits at 1/2 and ERFNet's, ESNet's, FDDWNet's and FSSNet's
# at full size; the ten models that need no new op, SQNet's, ADSCNet's
# and ESPNet's logits at full size, ContextNet's and FPENet's at 1/2,
# RegSeg's and DFANet's at 1/4, EDANet's, ESPNetv2's and CGNet's at 1/8
# (CGNet's, RegSeg's and DFANet's float32: their Dense gates promote the
# bf16 maps, as Flax's do); the six of the shuffle, dropout and argmax-pool
# ops, LEDNet's logits at 1/8, Lite-HRNet's at 1/4 (litehrnet18),
# AGLNet's at 1/2, and ENet's, MiniNet's and SegNet's at full size
def _smp(encoder: str, decoder: str) -> dict:
    return dict(model='smp', encoder=encoder, decoder=decoder, use_aux=False)


ZOO = (('FastSCNN', dict(model='fastscnn', use_aux=False), 8, 4),
       ('DDRNet-23-slim', dict(model='ddrnet', use_aux=True), 8, 4),
       ('STDC1', dict(model='stdc', use_aux=False, use_detail_head=True), 8,
        4),
       ('BiSeNetv1', dict(model='bisenetv1', use_aux=False), 8, 4),
       ('ICNet', dict(model='icnet', use_aux=True), 4, 4),
       ('SwiftNet', dict(model='swiftnet', use_aux=False), 4, 4),
       ('FarSeeNet', dict(model='farseenet', use_aux=False), 4, 4),
       ('ShelfNet', dict(model='shelfnet', use_aux=False), 4, 4),
       ('LinkNet', dict(model='linknet', use_aux=False), 1, 4),
       ('LiteSeg', dict(model='liteseg', use_aux=False), 8, 16),
       ('CANet', dict(model='canet', use_aux=False), 1, 16),
       ('PP-LiteSeg', dict(model='ppliteseg', use_aux=False), 8, 4),
       ('CFPNet', dict(model='cfpnet', use_aux=False), 8, 4),
       ('DABNet', dict(model='dabnet', use_aux=False), 8, 4),
       ('ERFNet', dict(model='erfnet', use_aux=False), 1, 4),
       ('ESNet', dict(model='esnet', use_aux=False), 1, 4),
       ('FDDWNet', dict(model='fddwnet', use_aux=False), 1, 4),
       ('FSSNet', dict(model='fssnet', use_aux=False), 1, 4),
       ('MiniNetv2', dict(model='mininetv2', use_aux=False), 2, 4),
       ('SQNet', dict(model='sqnet', use_aux=False), 1, 4),
       ('EDANet', dict(model='edanet', use_aux=False), 8, 4),
       ('ADSCNet', dict(model='adscnet', use_aux=False), 1, 4),
       ('ContextNet', dict(model='contextnet', use_aux=False), 2, 16),
       ('FPENet', dict(model='fpenet', use_aux=False), 2, 4),
       ('ESPNet', dict(model='espnet', use_aux=False), 1, 4),
       ('ESPNetv2', dict(model='espnetv2', use_aux=False), 8, 4),
       ('CGNet', dict(model='cgnet', use_aux=False), 8, 4),
       ('RegSeg', dict(model='regseg', use_aux=False), 4, 4),
       ('DFANet', dict(model='dfanet', use_aux=False), 4, 16),
       ('LEDNet', dict(model='lednet', use_aux=False), 8, 16),
       ('AGLNet', dict(model='aglnet', use_aux=False), 2, 4),
       ('Lite-HRNet', dict(model='lite_hrnet', use_aux=False), 4, 16),
       ('ENet', dict(model='enet', use_aux=False), 1, 4),
       ('MiniNet', dict(model='mininet', use_aux=False), 1, 4),
       ('SegNet', dict(model='segnet', use_aux=False), 1, 4),
       ('smp Unet', _smp('resnet18', 'unet'), 1, 4),
       ('smp Unet++', _smp('resnet18', 'unetpp'), 1, 4),
       ('smp LinkNet', _smp('resnet18', 'linknet'), 1, 4),
       ('smp FPN', _smp('resnet18', 'fpn'), 4, 4),
       ('smp MAnet', _smp('resnet18', 'manet'), 1, 4),
       ('smp PAN', _smp('resnet18', 'pan'), 4, 16),
       ('smp PSPNet', _smp('resnet18', 'pspnet'), 8, 4),
       ('smp DeepLabV3', _smp('resnet18', 'deeplabv3'), 8, 4),
       ('smp DeepLabV3+', _smp('resnet18', 'deeplabv3p'), 4, 4),
       ('smp FPN MiT-b2', _smp('mit_b2', 'fpn'), 4, 4))


# (constructor switches, steps) of a model's card-against-CPU train run
# where at its full depth and 3 steps float32 rounding alone goes beyond
# the check's limits (see _zoo_card_vs_cpu); the others run 3 steps at
# their registry defaults
ZOO_SMALL_RUN = {'mininetv2': (dict(feat_dt=(1, 2)), 1),
                 'fpenet': ({}, 1), 'regseg': ({}, 1),
                 'dfanet': (dict(repeat_times=(1, 1, 1)), 1),
                 'lednet': ({}, 1), 'aglnet': ({}, 1), 'segnet': ({}, 1),
                 'lite_hrnet': (dict(repeat=1), 1)}

# the models whose card-against-CPU run starts from Flax's initializers
# (the trainer's default weights) instead of the mapping check's draw
ZOO_FLAX_INIT = ('dfanet',)


# the zoo models whose train step torch.profiler reads: those new in this
# slice (the earlier ones' profiles are in PERF.md from their slices; the
# pass is dropped for them to keep the script near its time)
PROFILED = tuple(name for name, kw, _, _ in ZOO if kw['model'] == 'smp')


def zoo_key(kw) -> str:
    """The key of a zoo model in ZOO_SMALL_RUN and ZOO_FLAX_INIT: its model
    name, or smp-<encoder>-<decoder> for the hub's models."""
    if kw['model'] == 'smp':
        return f"smp-{kw['encoder']}-{kw['decoder']}"
    return kw['model']


def zoo_small_config(kw, samples):
    """The config switches of a zoo model's card-against-CPU train run: at
    64x128, or 128x128 for PAN, whose pool ladder halves the deepest map
    three times."""
    steps = ZOO_SMALL_RUN.get(zoo_key(kw), ({}, 3))[1]
    size = dict(crop_h=128, crop_w=128) if kw.get('decoder') == 'pan' \
        else {}
    return dict(base_lr=1e-3,
                weight_decay=0.5 if kw.get('use_detail_head') else 1e-4,
                train_bs=samples, val_bs=samples,
                synthetic_len=steps * samples, **size, **kw)


def zoo_small_variables(kw, model):
    """The weights a zoo model's card-against-CPU train run starts from:
    the mapping check's draw (utils/convert.py), as in earlier runs, or,
    for the models of ZOO_FLAX_INIT, Flax's initializers."""
    from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                               random_jax_variables)
    if zoo_key(kw) in ZOO_FLAX_INIT:
        return flax_init_variables(model, seed=1)
    return random_jax_variables(model, seed=1)


def zoo_small_model(kw):
    """The model builder of a zoo model's card-against-CPU train run: None
    (the registry's, at the model's full depth), or, for the models of
    ZOO_SMALL_RUN, one that builds the model at its cut depth."""
    cut = ZOO_SMALL_RUN.get(zoo_key(kw), ({}, 3))[0]
    if not cut:
        return None
    from rtseg_tpu_torch.models.registry import _PLAIN
    cls = _PLAIN[kw['model']]
    return lambda cfg, device=None: cls(num_class=cfg.num_class,
                                        device=device, **cut)


def _zoo_card_vs_cpu(name, variables, kw, samples, build=None):
    """3 float32 steps at 64x128 of `samples` distinct samples each on the
    card (deterministic cuDNN) and on the CPU, at a peak LR of 1e-3 and,
    for STDC, a weight decay of 0.5, so that the decay of detail_conv,
    which has no gradient, shows: it must have moved, and by the CPU's
    amount. The first step's metrics (the same weights: forward and loss)
    agree within 1e-5 relative; every step's within 1e-3 and the weights
    within 1e-3, as BiSeNetv2's: from random weights float32 rounding
    alone parts the later steps of two runs by more than 1e-5 (ROADMAP.md
    Queue 3).

    The MobileNetV2 models take 16 samples a step, so that its 1/32
    BatchNorms see 128 values a channel: at 4 (32 values) two CPU runs
    from weights 1e-7 apart parted LiteSeg's statistics by more than 1e-3
    themselves. STDC keeps 4: at 16 a sample's Dice denominator over the
    detail head's raw logits comes near 0, and the same two CPU runs
    parted its first-step loss by 2.7e-4 (zoo_check_spread.py; ROADMAP.md
    Queue 3).

    MiniNetv2 runs one step with its depth cut (ZOO_SMALL_RUN, `build`).
    Through its 30 depth-wise blocks float32 rounding grows until two CPU
    runs from weights 1e-7 apart part its first-step loss by 3.4e-5 and
    its weights by 1.09 after 3 steps of 4 samples. With two blocks at 1/8
    (16 in all) they still part its weights by 5.1e-3-6.3e-3 after 3
    steps of 4 samples and 2.7e-3-3.2e-3 of 16, and by 1.2e-4 after one
    step of 4 (zoo_check_spread.py), the depth and step the tests hold to
    the JAX package's (tests/test_torch_stem_train_steps.py).

    Three of the ten models that need no new op run one step, as the same
    two CPU runs say (zoo_check_spread.py): FPENet's weights part by
    4.6e-4-5.2e-4 after 3 steps of 4 samples (2.6e-4-3.1e-4 of 16) and by
    6.4e-6-9.2e-6 after one; RegSeg's by 3.5e-3 after 3 of 4 (6.7e-4-1.0e-3
    of 16) and by 8.7e-6-4.1e-5 after one. ContextNet takes 16 samples a
    step: at 4 its weights part by 1.9e-4-3.9e-4 after 3 steps, at 16 by
    7.5e-6-8.6e-6. DFANet's float32 run at random weights is chaotic at
    its full depth: its 1x1 FC attention maps give BatchNorms 4 values a
    channel, and its statistics part by 2.4e21 after 3 steps of 4. It runs
    one step of 16 samples with one block a stage (ZOO_SMALL_RUN) from
    Flax's initializers (ZOO_FLAX_INIT): its stem kernel parts by
    2.3e-5-2.4e-5 there, and from the mapping check's draw by
    5.0e-4-1.7e-3; 3 steps there part by 6.2e-3-7.8e-3, one step at full
    depth by 3.4e-2.

    Of the six models of the shuffle, dropout and argmax-pool ops, ENet and
    MiniNet run 3 steps of 4 (weights 5.1e-5-6.4e-5 and 6.0e-7-7.2e-7
    apart), with the same dropout masks on both devices
    (`cpu_dropout_masks`). LEDNet, AGLNet and SegNet run one step (LEDNet
    of 16 samples, the others of 4): after 3 of 4, their weights part by
    6.7e-4-8.8e-4, 2.7e-3-3.9e-3 and 1.1e-3-1.5e-3; after one by
    6.5e-6-1.0e-5, 5.4e-5-5.5e-5 and 4.5e-6-5.0e-6. LEDNet's first-step
    loss is sensitive: its attention head normalizes a conv of the global
    average, one value a sample and channel, and at 4 samples the same two
    CPU runs part it by 3.4e-6-1.5e-5 (the card parted from the CPU by
    9.6e-6); at 16 by 2.4e-6-4.6e-6 (the card by 6.0e-7).
    Lite-HRNet's BatchNorms over its pooled weights see a value a sample
    and channel: at full depth one step of 4 parts its stem kernel by
    1.0e-2-7.6e-2, of 16 by 2.6e-4-5.7e-4. It runs one step of 16 with one
    CCW block a branch (`repeat=1`, ZOO_SMALL_RUN): 1.6e-5-2.5e-5.

    Phase 6c's Adam and AdamW runs (OPTIM_CHECKS) take it at the start of
    a long warmup (OPTIM_SMALL), where Adam's sign-normalized updates
    part two runs least."""
    runs = _card_vs_cpu_runs(variables, ('cuda', 'cpu'), build,
                             **zoo_small_config(kw, samples))
    card, cpu = runs['cuda'], runs['cpu']
    first = _rel_loss(card[0][:1], cpu[0][:1])
    rel = _rel_loss(card[0], cpu[0])
    dw = _same_weights(card[1], cpu[1], math.inf)
    de = _same_weights(card[2], cpu[2], math.inf)
    extra = ''
    if kw.get('use_detail_head'):
        k0 = np.asarray(variables['params']['detail_conv']['conv']['kernel'])
        kc, kp = (np.asarray(r[1]['params']['detail_conv']['conv']['kernel'])
                  for r in (card, cpu))
        moved = float(np.abs(kc - k0).max())
        extra = (f'; detail_conv (no gradient) moved {moved:.3e} by weight '
                 f'decay, card - CPU {float(np.abs(kc - kp).max()):.2e} '
                 f'(tolerance 1e-6)')
    say(f'zoo {name} small fp32 train, card (deterministic cuDNN) vs CPU, '
        f'{len(card[0])} steps of {samples} samples: {card[0]} vs {cpu[0]}; '
        f'first step {first:.2e} relative '
        f'(tolerance 1e-5), all steps {rel:.2e} (tolerance 1e-3); params+BN '
        f'statistics {dw[0]:.2e} ({dw[1]}), EMA {de[0]:.2e} ({de[1]}); '
        f'tolerance 1e-3 absolute and relative{extra}')
    check(first <= 1e-5, f'{name} card vs CPU first-step loss {first}')
    check(rel <= 1e-3, f'{name} card vs CPU train losses differ by {rel}')
    _same_weights(card[1], cpu[1], 1e-3, f'{name} params')
    _same_weights(card[2], cpu[2], 1e-3, f'{name} EMA')
    if kw.get('use_detail_head'):
        check(moved > 1e-4, f'{name} detail_conv moved {moved}')
        check(np.allclose(kc, kp, atol=1e-6, rtol=1e-6),
              f'{name} detail_conv card {kc.ravel()} CPU {kp.ravel()}')
    return first, rel, max(dw, de)[0]


def _eval_peak(step, imgs, msks) -> int:
    """The peak memory allocated during one eval step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(imgs, msks)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase_zoo(dev, card, eval_imgs, eval_msks):
    """Each model of ZOO: SegTrainer(cfg).run() from the trainer's default
    weights (the initializers of Flax's model.init) at 512x1024 bs16 bf16
    (SGD OneCycle, EMA, OHEM) for 1 epoch of 3 steps and a validation of 16
    images (then val_best's) through K1 and K2 with their launch counts;
    K1 and K2 on the EMA model's logits of a val batch against their plain
    versions; 3 float32 steps card vs CPU; the step's times, its profile,
    peak memory and the eval step at 1024x2048 with K1 and K2 timed on the
    model's logits. A model
    whose logits come at full resolution takes the eval step's
    identity-size argmax: K1 is not launched for it."""
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.ops.fused_head import _argmax_ref, resize_argmax
    from rtseg_tpu_torch.ops.pallas_metrics import (confusion_matrix_pallas,
                                                    confusion_matrix_plain)
    from rtseg_tpu_torch.train import SegTrainer, build_eval_step

    launches = {'resize_argmax': 0, 'confusion_matrix': 0}
    out = {}
    for name, kw, stride, samples in ZOO:
        t_model = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix='chip_smoke_zoo_')
        try:
            cfg = _train_config(tmp, synthetic_len=3 * B, total_epoch=1,
                                **kw)
            trainer = SegTrainer(cfg)
            n_val = len(trainer.val_loader)
            check(n_val == 1, f'{name}: {n_val} val batches')
            resize_argmax.launches = 0
            confusion_matrix_pallas.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            miou = trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {'resize_argmax': resize_argmax.launches,
                   'confusion_matrix': confusion_matrix_pallas.launches}
            losses = trainer.epoch_losses
            say(f'zoo {name}: bf16, {cfg.loss_type}, aux {cfg.use_aux}, '
                f'detail head {cfg.use_detail_head}, SGD cos_warmup, EMA; '
                f'{len(trainer.train_loader)} steps of {B}x{TRAIN_H}x'
                f'{TRAIN_W}; run() {wall:.3f} s (cold); epoch loss {losses}; '
                f'step {trainer.state.step}; val_best mIoU {miou:.6f}; '
                f'launches {got} for {2 * n_val} val batches')
            check(len(losses) == 1 and math.isfinite(losses[0]),
                  f'{name} epoch losses {losses}')
            check(trainer.state.step == 3, f'{name} step {trainer.state.step}')
            check(math.isfinite(miou), f'{name} mIoU is not finite')
            # the epoch's validation and val_best's; full-resolution logits
            # take the identity-size argmax and launch no K1
            want = {'resize_argmax': 2 * n_val if stride > 1 else 0,
                    'confusion_matrix': 2 * n_val}
            check(got == want, f'{name} launch counts {got} != {want}')
            for k, v in got.items():
                launches[k] += v
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # K1 and K2 on the EMA model's deferred bf16 logits of the val batch
        imgs, msks = next(iter(trainer.val_loader))
        imgs, msks = imgs.to(dev), msks.to(dev)
        with torch.inference_mode():
            low = trainer.ema_model(imgs.to(torch.bfloat16),
                                    defer_upsample=True).contiguous()
        shape = (B, TRAIN_H // stride, TRAIN_W // stride, C)
        check(tuple(low.shape) == shape,
              f'{name} deferred logits {tuple(low.shape)}')
        preds = resize_argmax(low, (TRAIN_H, TRAIN_W))
        k1_rate = _rate(preds, _argmax_ref(low.float(), (TRAIN_H, TRAIN_W)))
        cm = confusion_matrix_pallas(preds, msks, C, IGNORE)
        k2_equal = torch.equal(cm, confusion_matrix_plain(preds, msks, C,
                                                          IGNORE))
        say(f'zoo {name}: K1 on the EMA model\'s {str(low.dtype)[6:]} '
            f'logits {tuple(low.shape)} -> {TRAIN_H}x{TRAIN_W}'
            + (' (identity size: the plain argmax)' if stride == 1 else '')
            + f': mismatch {k1_rate:.3e} against the float32 plain version '
            f'(tolerance 1e-4); K2 there bit-equal {k2_equal}, total '
            f'{int(cm.sum())}')
        check(k1_rate <= 1e-4, f'{name} K1 mismatch {k1_rate}')
        check(k2_equal, f'{name} K2 differs from its plain version')
        del low, preds

        build = zoo_small_model(kw)
        variables = zoo_small_variables(kw, (build or get_model)(cfg))
        cpu_first, cpu_rel, cpu_abs = _zoo_card_vs_cpu(
            name, variables, kw, samples, build)

        # times: the train step on a resident train batch
        trainer.train_loader.set_epoch(0)
        imgs, msks = next(iter(trainer.train_loader))
        imgs, msks = imgs.to(dev), msks.to(dev)
        _, metrics = trainer.train_step(trainer.state, imgs, msks)
        check(all(math.isfinite(float(v)) for v in metrics.values())
              and ('loss_detail' in metrics) == bool(cfg.use_detail_head),
              f'{name} train step metrics {metrics}')
        step_ms, parts, peak, before = _step_times(trainer, cfg, imgs, msks)
        profile = _profile_step(trainer.train_step, trainer.state, imgs,
                                msks, label=f'zoo {name} train') \
            if name in PROFILED else None
        # the eval step at 1024x2048 and K1, K2 on the model's logits there
        step = build_eval_step(cfg, trainer.ema_model, dev)
        eval_ms = time_ms(lambda: step(eval_imgs, eval_msks), iters=5)
        eval_peak = _eval_peak(step, eval_imgs, eval_msks)
        if kw.get('encoder', '').startswith('mit_'):
            say(f'zoo {name} eval peak memory at {H}x{W} bs{B} ({card}): '
                f'{eval_peak / 2**30:.3f} GiB (attention in query slices of '
                f'at most 2^28 elements a call)')
        with torch.inference_mode():
            low = trainer.ema_model(eval_imgs.to(torch.bfloat16),
                                    defer_upsample=True).contiguous()
        check(tuple(low.shape) == (B, H // stride, W // stride, C),
              f'{name} logits {low.shape}')
        preds = resize_argmax(low, (H, W))
        rate = _rate(preds, _argmax_ref(low.float(), (H, W)))
        check(rate <= 1e-4, f'{name} K1 mismatch at {H}x{W}: {rate}')
        check(torch.equal(confusion_matrix_pallas(preds, eval_msks, C, IGNORE),
                          confusion_matrix_plain(preds, eval_msks, C,
                                                 IGNORE)),
              f'{name} K2 differs from its plain version at {H}x{W}')
        k1_ms = time_ms(lambda: resize_argmax(low, (H, W))) \
            if stride > 1 else None
        k2_ms = time_ms(
            lambda: confusion_matrix_pallas(preds, eval_msks, C, IGNORE))
        k1_text = (f'K1 {k1_ms:.4f} ms on {tuple(low.shape)}' if k1_ms
                   else f'no K1 (logits {tuple(low.shape)} at full size)')
        del low, preds
        say(f'zoo {name} times ({card}): train step on a resident batch '
            f'{step_ms:.3f} ms = {B / step_ms * 1e3:.2f} imgs/s; split '
            f'forward+loss {parts[0]:.3f} ms, backward {parts[1]:.3f} ms, '
            f'optimizer+EMA {parts[2]:.3f} ms; peak memory of a step '
            f'{peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB allocated '
            f'before it); run() {wall:.3f} s cold; eval step at {H}x{W} '
            f'{eval_ms:.3f} ms = {B / eval_ms * 1e3:.2f} imgs/s, peak '
            f'memory {eval_peak / 2**30:.3f} GiB; on its '
            f'logits {k1_text} (mismatch {rate:.3e} against the float32 '
            f'plain version), K2 {k2_ms:.4f} ms (bit-equal); this model\'s '
            f'checks and times took {time.perf_counter() - t_model:.1f} s')
        out[name] = {'step_ms': step_ms, 'parts_ms': parts.tolist(),
                     'peak_bytes': peak, 'run_cold_s': wall,
                     'eval_ms': eval_ms, 'eval_peak_bytes': eval_peak,
                     'logits_stride': stride,
                     'k1_ms': k1_ms, 'k2_ms': k2_ms,
                     'profile': profile,
                     'card_vs_cpu_first_loss': cpu_first,
                     'card_vs_cpu_loss': cpu_rel,
                     'card_vs_cpu_weights': cpu_abs,
                     'card_vs_cpu_samples': samples}
        del trainer, step
    return launches, out


# ----------------------------------------------------------------- phase 6b
# the reference README's KD pair: a ResNet-101 DeepLabV3+ teacher (output
# stride 16) and a ResNet-18 DeepLabV3+ student distilled with the KL
# divergence at temperature 4, coefficient 1
KD_TEACHER = _smp('resnet101', 'deeplabv3p')
KD_STUDENT = dict(_smp('resnet18', 'deeplabv3p'), kd_training=True,
                  kd_loss_type='kl_div', kd_temperature=4.0,
                  kd_loss_coefficient=1.0, teacher_encoder='resnet101',
                  teacher_decoder='deeplabv3p')
# samples a step and steps of the KD card-against-CPU run
KD_SMALL = (4, 3)


def teacher_checkpoint(save_dir: str, variables) -> str:
    """A best.ckpt of the KD teacher with `variables`, written into
    `save_dir`; its path."""
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.train.checkpoint import save_best_ckpt
    from rtseg_tpu_torch.train.state import TrainState
    from rtseg_tpu_torch.utils.convert import load_jax_variables
    cfg = _train_config(save_dir, **KD_TEACHER)
    teacher = get_model(cfg)
    load_jax_variables(teacher, variables)
    path = str(Path(save_dir) / 'best.ckpt')
    save_best_ckpt(path, TrainState(0, teacher, None, teacher), 1, 0.0)
    return path


def kd_small_config(teacher_ckpt: str) -> dict:
    samples, steps = KD_SMALL
    return dict(zoo_small_config(KD_STUDENT, samples),
                synthetic_len=steps * samples, teacher_ckpt=teacher_ckpt)


def kd_small_variables(seed: int = 1):
    """The student's and the teacher's weights of the KD card-against-CPU
    run: the mapping check's draws."""
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.utils.convert import random_jax_variables
    return (random_jax_variables(get_model(_train_config(
                'unused', **KD_STUDENT)), seed=seed),
            random_jax_variables(get_model(_train_config(
                'unused', **KD_TEACHER)), seed=seed + 1))


def _kd_card_vs_cpu(tmp: str):
    """KD_SMALL float32 steps of the KD student at 64x128 on the card
    (deterministic cuDNN) and on the CPU from the same weights and teacher
    checkpoint, with the same dropout masks (ASPP's): the first step's
    loss and loss_kd within 1e-5 relative, every step's within 1e-3, the
    weights and their EMA within 1e-3."""
    student, teacher = kd_small_variables()
    ckpt = teacher_checkpoint(str(Path(tmp) / 'small_teacher'), teacher)
    runs = _card_vs_cpu_runs(student, ('cuda', 'cpu'), **kd_small_config(
        ckpt))
    card, cpu = runs['cuda'], runs['cpu']
    first = _rel_loss(card[0][:1], cpu[0][:1])
    rel = _rel_loss(card[0], cpu[0])
    dw = _same_weights(card[1], cpu[1], math.inf)
    de = _same_weights(card[2], cpu[2], math.inf)
    say(f'kd small fp32 train, card (deterministic cuDNN) vs CPU, '
        f'{len(card[0])} steps of {KD_SMALL[0]} samples: {card[0]} vs '
        f'{cpu[0]}; first step (loss, loss_kd) {first:.2e} relative '
        f'(tolerance 1e-5), all steps {rel:.2e} (tolerance 1e-3); '
        f'params+BN statistics {dw[0]:.2e} ({dw[1]}), EMA {de[0]:.2e} '
        f'({de[1]}); tolerance 1e-3 absolute and relative')
    check(all('loss_kd' in m for m in card[0] + cpu[0]),
          'the KD run reports no loss_kd')
    check(first <= 1e-5, f'KD card vs CPU first-step metrics {first}')
    check(rel <= 1e-3, f'KD card vs CPU train metrics differ by {rel}')
    _same_weights(card[1], cpu[1], 1e-3, 'KD params')
    _same_weights(card[2], cpu[2], 1e-3, 'KD EMA')
    return first, rel, max(dw, de)[0]


def phase_kd(dev, card, eval_imgs, eval_msks):
    """Knowledge distillation at the README's pair: the teacher's run()
    (1 epoch of 3 steps at 512x1024 bs16 bf16, a validation and
    val_best), whose best.ckpt (or, where no validation improved on 0, its
    final EMA weights) the student's run() loads as its frozen teacher for
    1 epoch of 3 steps with the KD term, a validation and val_best, all
    through K1 and K2 with their launch counts read around each run. The
    teacher's weights are unchanged after the student's run and in neither
    its optimizer nor its checkpoints. K1 and K2 on the student's EMA
    logits; the KD card-against-CPU check; the student's step with and
    without KD, the teacher's forward alone, and the student's eval step at
    1024x2048."""
    from rtseg_tpu_torch.ops.fused_head import _argmax_ref, resize_argmax
    from rtseg_tpu_torch.ops.pallas_metrics import (confusion_matrix_pallas,
                                                    confusion_matrix_plain)
    from rtseg_tpu_torch.train import (SegTrainer, build_eval_step,
                                       build_train_step)
    from rtseg_tpu_torch.train.checkpoint import save_best_ckpt
    from rtseg_tpu_torch.utils.convert import _flatten, to_jax_variables

    def counted_run(trainer):
        resize_argmax.launches = 0
        confusion_matrix_pallas.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {'resize_argmax': resize_argmax.launches,
               'confusion_matrix': confusion_matrix_pallas.launches}
        n_val = len(trainer.val_loader)
        # DeepLabV3+'s logits at 1/4: K1 and K2 a val batch, for the
        # epoch's validation and val_best's
        want = {'resize_argmax': 2 * n_val, 'confusion_matrix': 2 * n_val}
        check(got == want, f'KD launch counts {got} != {want}')
        check(trainer.state.step == 3 and len(trainer.epoch_losses) == 1
              and math.isfinite(trainer.epoch_losses[0])
              and math.isfinite(miou),
              f'KD run: step {trainer.state.step}, losses '
              f'{trainer.epoch_losses}, mIoU {miou}')
        return got, wall, miou

    launches = {'resize_argmax': 0, 'confusion_matrix': 0}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_kd_')
    try:
        tdir = str(Path(tmp) / 'teacher')
        tcfg = _train_config(tdir, synthetic_len=3 * B, total_epoch=1,
                             **KD_TEACHER)
        teacher_run = SegTrainer(tcfg)
        got, t_wall, t_miou = counted_run(teacher_run)
        for k, v in got.items():
            launches[k] += v
        ckpt = str(Path(tdir) / 'best.ckpt')
        if not (Path(ckpt) / 'state.pt').exists():
            save_best_ckpt(ckpt, teacher_run.state, 1, teacher_run.best_score)
        teacher_weights = to_jax_variables(teacher_run.ema_model)
        del teacher_run
        say(f'kd teacher: ResNet-101 DeepLabV3+ bf16 run() {t_wall:.3f} s '
            f'(cold), 3 steps of {B}x{TRAIN_H}x{TRAIN_W}, val_best mIoU '
            f'{t_miou:.6f}, launches {got}; its EMA weights in {ckpt}')

        scfg = _train_config(str(Path(tmp) / 'student'),
                             synthetic_len=3 * B, total_epoch=1,
                             teacher_ckpt=ckpt, **KD_STUDENT)
        student = SegTrainer(scfg)
        teacher = student.teacher
        _same_weights(to_jax_variables(teacher), teacher_weights)
        t_params = {id(p) for p in teacher.parameters()}
        opt_params = {id(p) for g in student.state.optimizer.param_groups
                      for p in g['params']}
        check(not t_params & opt_params
              and not any(p.requires_grad for p in teacher.parameters())
              and not teacher.training
              and next(teacher.parameters()).device.type == 'cuda',
              'the teacher is not frozen on the card outside the optimizer')
        got, s_wall, s_miou = counted_run(student)
        for k, v in got.items():
            launches[k] += v
        _same_weights(to_jax_variables(teacher), teacher_weights)
        check(not teacher.training, 'the teacher left eval mode')
        check(len(student.epoch_kd_losses) == 1
              and math.isfinite(student.epoch_kd_losses[0]),
              f'KD losses {student.epoch_kd_losses}')
        own = set(_flatten(to_jax_variables(student.model)))
        for name in ('last.ckpt', 'best.ckpt'):
            payload = torch.load(Path(tmp) / 'student' / name / 'state.pt',
                                 weights_only=True)
            for key, tree in payload.items():
                if key != 'step':
                    leaves = set(_flatten(tree))
                    check(leaves <= own, f'{name}/{key} holds leaves the '
                                         f'student has not')
            check(set(_flatten(payload['variables'])) == own,
                  f'{name} does not hold the student alone')
        say(f'kd student: ResNet-18 DeepLabV3+ bf16 with KL KD (T 4, '
            f'coefficient 1) run() {s_wall:.3f} s (cold), epoch loss '
            f'{student.epoch_losses}, KD term {student.epoch_kd_losses}, '
            f'val_best mIoU {s_miou:.6f}, launches {got}; the teacher '
            f'frozen on the card (no gradient, eval mode, outside the '
            f'optimizer), its weights unchanged, and the checkpoints hold '
            f'the student\'s {len(own)} leaves alone')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # K1 and K2 on the student's EMA logits of a val batch
    imgs, msks = next(iter(student.val_loader))
    imgs, msks = imgs.to(dev), msks.to(dev)
    with torch.inference_mode():
        low = student.ema_model(imgs.to(torch.bfloat16),
                                defer_upsample=True).contiguous()
    check(tuple(low.shape) == (B, TRAIN_H // 4, TRAIN_W // 4, C),
          f'KD student logits {tuple(low.shape)}')
    preds = resize_argmax(low, (TRAIN_H, TRAIN_W))
    k1_rate = _rate(preds, _argmax_ref(low.float(), (TRAIN_H, TRAIN_W)))
    k2_equal = torch.equal(confusion_matrix_pallas(preds, msks, C, IGNORE),
                           confusion_matrix_plain(preds, msks, C, IGNORE))
    say(f'kd student: K1 on the EMA model\'s logits {tuple(low.shape)}: '
        f'mismatch {k1_rate:.3e} against the float32 plain version '
        f'(tolerance 1e-4); K2 bit-equal {k2_equal}')
    check(k1_rate <= 1e-4, f'KD student K1 mismatch {k1_rate}')
    check(k2_equal, 'KD student K2 differs from its plain version')
    del low, preds

    small_tmp = tempfile.mkdtemp(prefix='chip_smoke_kd_small_')
    try:
        cpu_first, cpu_rel, cpu_abs = _kd_card_vs_cpu(small_tmp)
    finally:
        shutil.rmtree(small_tmp, ignore_errors=True)

    # times on a resident train batch
    student.train_loader.set_epoch(0)
    imgs, msks = next(iter(student.train_loader))
    imgs, msks = imgs.to(dev), msks.to(dev)
    step_ms, parts, peak, before = _step_times(student, scfg, imgs, msks)
    plain_cfg = copy.copy(student.config)
    plain_cfg.kd_training = False
    plain_step = build_train_step(plain_cfg)
    plain_ms = time_ms(lambda: plain_step(student.state, imgs, msks),
                       iters=5, warmup=2)
    student.model.eval()
    x = imgs.to(torch.bfloat16)
    with torch.no_grad():
        teacher_ms = time_ms(lambda: teacher(x), iters=5, warmup=2)
    profile = _profile_step(student.train_step, student.state, imgs, msks,
                            label='kd student')
    step = build_eval_step(scfg, student.ema_model, dev)
    eval_ms = time_ms(lambda: step(eval_imgs, eval_msks), iters=5)
    eval_peak = _eval_peak(step, eval_imgs, eval_msks)
    with torch.inference_mode():
        low = student.ema_model(eval_imgs.to(torch.bfloat16),
                                defer_upsample=True).contiguous()
    k1_ms = time_ms(lambda: resize_argmax(low, (H, W)))
    del low
    say(f'kd times ({card}): student step with KD {step_ms:.3f} ms = '
        f'{B / step_ms * 1e3:.2f} imgs/s (split forward+loss with the '
        f'teacher {parts[0]:.3f} ms, backward {parts[1]:.3f} ms, '
        f'optimizer+EMA {parts[2]:.3f} ms; peak memory '
        f'{peak / 2**30:.3f} GiB, {before / 2**30:.3f} GiB allocated before '
        f'it); without KD {plain_ms:.3f} ms; the teacher\'s bf16 forward '
        f'alone {teacher_ms:.3f} ms; KD adds {step_ms - plain_ms:.3f} ms; '
        f'student eval step at {H}x{W} {eval_ms:.3f} ms, peak '
        f'{eval_peak / 2**30:.3f} GiB, K1 on its logits {k1_ms:.4f} ms')
    return launches, {
        'teacher_run_cold_s': t_wall, 'student_run_cold_s': s_wall,
        'step_ms': step_ms, 'parts_ms': parts.tolist(), 'peak_bytes': peak,
        'step_without_kd_ms': plain_ms, 'teacher_forward_ms': teacher_ms,
        'kd_losses': student.epoch_kd_losses, 'profile': profile,
        'eval_ms': eval_ms, 'eval_peak_bytes': eval_peak, 'k1_ms': k1_ms,
        'card_vs_cpu_first_metrics': cpu_first, 'card_vs_cpu_loss': cpu_rel,
        'card_vs_cpu_weights': cpu_abs}


# ----------------------------------------------------------------- phase 6c
# the optimizer tail: AdamW on the smp FPN over MiT-b2 (the encoder family
# trained with AdamW), Adam with remat on the flagship BiSeNetv2
OPTIM_MIT = dict(_smp('mit_b2', 'fpn'), optimizer_type='adamw')
OPTIM_FLAGSHIP = dict(model='bisenetv2', use_aux=True,
                      optimizer_type='adam')
# the models whose step runs with and without remat: the flagship, ENet
# (Dropout2d), MiT-b2 FPN (drop path, LayerNorm) and SegNet (the largest
# peak of the zoo)
REMAT_MODELS = (('BiSeNetv2', dict(model='bisenetv2', use_aux=True)),
                ('ENet', dict(model='enet', use_aux=False)),
                ('smp FPN MiT-b2', _smp('mit_b2', 'fpn')),
                ('SegNet', dict(model='segnet', use_aux=False)))
# the card-against-CPU runs under Adam and AdamW: (name, config switches,
# samples a step), 3 float32 steps at 64x128 at the start of a long
# warmup (OPTIM_SMALL), the LR near its floor of 1e-3 / 25. Adam moves an
# element by about the LR whichever sign the rounding gives its gradient,
# so where an element's gradient is rounding noise two runs part by up to
# twice the LRs summed: at the zoo's schedule (4e-5, 5.2e-4, 1e-3) 3.1e-3,
# beyond the 1e-3 limit; at OPTIM_SMALL 2.4e-4. There two CPU runs from
# weights 1e-7 apart part by 1.5e-4-1.7e-4 in BiSeNetv2's weights and by
# 1.9e-5-2.2e-5 in MiT-b2 FPN's (zoo_check_spread.py adam-bisenetv2:4
# adamw-smp-mit_b2-fpn:4)
OPTIM_SMALL = dict(total_epoch=100, warmup_epochs=50)
OPTIM_CHECKS = (('BiSeNetv2 Adam', dict(OPTIM_FLAGSHIP, **OPTIM_SMALL), 4),
                ('smp FPN MiT-b2 AdamW', dict(OPTIM_MIT, **OPTIM_SMALL), 4))
# ImageNet's normalize of the data pipeline (scale, bias): the host path's
# coefficients for the uint8 tail, 1 / (255 std) and -mean / std
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
NORM_COEFFS = (np.float32(1.0) / (255.0 * _STD), (-_MEAN / _STD).astype(
    np.float32))


def host_flip_norm(images: np.ndarray, masks: np.ndarray,
                   flags: np.ndarray):
    """The host path of the uint8 tail, sample by sample: flip, then
    f32(f32(v) * scale) + bias."""
    scale, bias = NORM_COEFFS
    out = np.empty(images.shape, np.float32)
    flipped = np.empty_like(masks)
    for i, (h_flip, v_flip) in enumerate(flags):
        x, m = images[i], masks[i]
        if h_flip:
            x, m = x[:, ::-1], m[:, ::-1]
        if v_flip:
            x, m = x[::-1], m[::-1]
        out[i] = x.astype(np.float32)
        out[i] *= scale
        out[i] += bias
        flipped[i] = m
    return out, flipped


def _adam_state(trainer):
    """{parameter name: {'step', 'exp_avg', 'exp_avg_sq'}} of a trainer."""
    names = {p: n for n, p in trainer.model.named_parameters()}
    return {names[p]: s for p, s in trainer.state.optimizer.state.items()}


def _same_adam_state(a, b, what):
    sa, sb = _adam_state(a), _adam_state(b)
    check(sa.keys() == sb.keys() == dict(a.model.named_parameters()).keys(),
          f'{what}: Adam state of other parameters')
    for n, s in sa.items():
        check(s.keys() == sb[n].keys() == {'step', 'exp_avg', 'exp_avg_sq'}
              and all(torch.equal(s[k], sb[n][k]) for k in s),
              f'{what}: Adam state of {n} differs')


def _counted(fn):
    """(result of fn(), {kernel: launches in it})."""
    from rtseg_tpu_torch.ops.fused_head import resize_argmax
    from rtseg_tpu_torch.ops.pallas_metrics import confusion_matrix_pallas
    resize_argmax.launches = 0
    confusion_matrix_pallas.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {'resize_argmax': resize_argmax.launches,
                 'confusion_matrix': confusion_matrix_pallas.launches}


def _deterministic(flag: bool) -> bool:
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = flag
    return old


def _remat_pair(name, kw, dev):
    """One bf16 step of `kw` at 512x1024 bs16 on a resident batch from the
    same Flax init, without and with remat, deterministic cuDNN: loss,
    weights, BatchNorm statistics, EMA and Adam's state equal bit for bit,
    the recompute asking the step's generator for no mask; then both
    steps' times and peaks."""
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.nn import DropoutMasks
    from rtseg_tpu_torch.train import SegTrainer, build_train_step
    from rtseg_tpu_torch.train.step import dropout_seed
    from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                               to_jax_variables)
    cfg_kw = dict(synthetic_len=B, total_epoch=1, optimizer_type='adam',
                  save_ckpt=False, load_ckpt=False, **kw)
    variables = flax_init_variables(get_model(_train_config(
        'unused', **cfg_kw), device=dev), seed=1)
    pair, draws, out = [], [], {}
    for remat in (False, True):
        t = SegTrainer(_train_config('unused', remat=remat, **cfg_kw),
                       variables=variables)
        count = [0]
        gen = torch.Generator(device=dev)

        def source(k, count=count, gen=gen, seed=t.config.random_seed):
            gen.manual_seed(dropout_seed(seed, k))
            masks = DropoutMasks(gen)

            def counted(*args):
                count[0] += 1
                return masks(*args)
            return counted
        t.train_step = build_train_step(t.config, dropout_masks=source)
        pair.append(t)
        draws.append(count)
    pair[0].train_loader.set_epoch(0)
    imgs, msks = next(iter(pair[0].train_loader))
    imgs, msks = imgs.to(dev), msks.to(dev)
    old = _deterministic(True)
    try:
        losses = [t.train_step(t.state, imgs, msks)[1]['loss'] for t in pair]
    finally:
        _deterministic(old)
    a, b = pair
    check(torch.equal(losses[0], losses[1]),
          f'{name} remat loss {float(losses[1])} != {float(losses[0])}')
    worst = max(_same_weights(to_jax_variables(b.model),
                              to_jax_variables(a.model), math.inf),
                _same_weights(to_jax_variables(b.ema_model),
                              to_jax_variables(a.ema_model), math.inf))
    check(worst[0] == 0.0, f'{name} remat weights differ by {worst}')
    _same_adam_state(a, b, f'{name} remat')
    check(draws[0][0] == draws[1][0],
          f'{name}: {draws[1][0]} masks drawn with remat, {draws[0][0]} '
          f'without')
    out['masks_drawn'] = draws[0][0]
    for label, t in (('plain', a), ('remat', b)):
        ms = time_ms(lambda: t.train_step(t.state, imgs, msks), iters=3,
                     warmup=1)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t.train_step(t.state, imgs, msks)
        torch.cuda.synchronize()
        out[label] = {'step_ms': ms,
                      'peak_bytes': torch.cuda.max_memory_allocated(),
                      'before_bytes': before}
    for t in pair:
        t.model.eval()
    say(f'optim remat {name}: one Adam step of {B}x{TRAIN_H}x{TRAIN_W} bf16 '
        f'with and without remat, deterministic cuDNN: loss {float(losses[0])}'
        f' both, weights, BN statistics, EMA and Adam state bit-equal, '
        f'{out["masks_drawn"]} masks drawn in each; step '
        f'{out["plain"]["step_ms"]:.3f}'
        f' ms without, {out["remat"]["step_ms"]:.3f} ms with; peak '
        f'{out["plain"]["peak_bytes"] / 2**30:.3f} GiB without, '
        f'{out["remat"]["peak_bytes"] / 2**30:.3f} GiB with '
        f'({out["remat"]["before_bytes"] / 2**30:.3f} GiB allocated before '
        f'the step)')
    return out


def phase_optim(dev, card, eval_imgs, eval_msks):
    """The optimizer tail on the card at full width (bs16, 512x1024 train
    crop, 1024x2048 eval, bf16, 19 classes, Flax init, OHEM, OneCycle,
    EMA): (a) AdamW on smp FPN over MiT-b2: run() for 1 epoch of 3 steps
    through K1 and K2, a fresh trainer resumes last.ckpt bit for bit and
    one more step from each is bit-equal, the step's times; (b) Adam with
    remat on BiSeNetv2 with its aux heads: run(), and the step with and
    without remat on four models; (c) the uint8 tail: device_flip_norm on
    the card against the CPU, the train step with norm_coeffs against the
    float step on the host-normalized batch, the eval step with
    norm_coeffs against the float one (counted); (d) 3 float32 steps card
    against CPU under Adam and AdamW."""
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.ops.augment import device_flip_norm
    from rtseg_tpu_torch.train import (SegTrainer, build_eval_step,
                                       build_train_step)
    from rtseg_tpu_torch.utils.convert import to_jax_variables

    launches = {'resize_argmax': 0, 'confusion_matrix': 0}
    out = {}

    def counted_run(what, trainer):
        wall_start = time.perf_counter()
        miou, got = _counted(trainer.run)
        wall = time.perf_counter() - wall_start
        n_val = len(trainer.val_loader)
        want = {'resize_argmax': 2 * n_val, 'confusion_matrix': 2 * n_val}
        check(got == want, f'{what} launch counts {got} != {want}')
        check(trainer.state.step == 3 and len(trainer.epoch_losses) == 1
              and math.isfinite(trainer.epoch_losses[0])
              and math.isfinite(miou),
              f'{what} run: step {trainer.state.step}, losses '
              f'{trainer.epoch_losses}, mIoU {miou}')
        for k, v in got.items():
            launches[k] += v
        say(f'optim {what}: run() {wall:.3f} s (cold), 3 steps of {B}x'
            f'{TRAIN_H}x{TRAIN_W} bf16, epoch loss {trainer.epoch_losses}, '
            f'val_best mIoU {miou:.6f}, launches {got}')
        return wall, miou

    # (a) AdamW on MiT-b2 FPN: run, resume, one more step, times
    tmp = tempfile.mkdtemp(prefix='chip_smoke_optim_')
    try:
        cfg = _train_config(tmp, synthetic_len=3 * B, total_epoch=1,
                            **OPTIM_MIT)
        mit = SegTrainer(cfg)
        wall, miou = counted_run('MiT-b2 FPN AdamW', mit)
        resumed = SegTrainer(_train_config(tmp, synthetic_len=3 * B,
                                           total_epoch=1, **OPTIM_MIT))
        check(resumed.state.step == mit.state.step == 3
              and resumed.cur_epoch == 1, f'resumed at step '
              f'{resumed.state.step}, epoch {resumed.cur_epoch}')
        last = torch.load(Path(tmp) / 'last.ckpt' / 'state.pt',
                          weights_only=True)
        _same_weights(to_jax_variables(resumed.model),
                      to_jax_variables(mit.model))
        _same_weights(to_jax_variables(resumed.ema_model),
                      last['ema_variables'])
        _same_weights(to_jax_variables(mit.ema_model),
                      last['ema_variables'])
        _same_adam_state(mit, resumed, 'MiT-b2 resume')
        mit.train_loader.set_epoch(1)
        imgs, msks = next(iter(mit.train_loader))
        imgs, msks = imgs.to(dev), msks.to(dev)
        old = _deterministic(True)
        try:
            l1 = [t.train_step(t.state, imgs, msks)[1]['loss']
                  for t in (mit, resumed)]
        finally:
            _deterministic(old)
        check(torch.equal(l1[0], l1[1]), f'one more step: {l1}')
        _same_weights(to_jax_variables(resumed.model),
                      to_jax_variables(mit.model))
        _same_weights(to_jax_variables(resumed.ema_model),
                      to_jax_variables(mit.ema_model))
        _same_adam_state(mit, resumed, 'MiT-b2 one more step')
        say(f'optim resume: a fresh trainer holds last.ckpt\'s weights, '
            f'AdamW moments and counts, step and EMA bit for bit; one more '
            f'step from each (deterministic cuDNN): loss {float(l1[0])} '
            f'both, weights, EMA and Adam state bit-equal')
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_ms, parts, peak, before = _step_times(mit, cfg, imgs, msks)
    say(f'optim MiT-b2 FPN AdamW times ({card}): train step on a resident '
        f'batch {step_ms:.3f} ms = {B / step_ms * 1e3:.2f} imgs/s; split '
        f'forward+loss {parts[0]:.3f} ms, backward {parts[1]:.3f} ms, '
        f'optimizer+EMA {parts[2]:.3f} ms; peak memory of a step '
        f'{peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB allocated before '
        f'it); under SGD (PERF.md section 5): 183.838 ms, optimizer+EMA '
        f'1.777 ms, 23.145 GiB')
    out['mit_adamw'] = {'run_cold_s': wall, 'miou': miou, 'step_ms': step_ms,
                        'parts_ms': parts.tolist(), 'peak_bytes': peak,
                        'params': sum(p.numel()
                                      for p in mit.model.parameters())}
    del mit

    # (b) Adam with remat on the flagship, and remat's equality and cost
    tmp = tempfile.mkdtemp(prefix='chip_smoke_remat_')
    try:
        flag = SegTrainer(_train_config(tmp, synthetic_len=3 * B,
                                        total_epoch=1, remat=True,
                                        **OPTIM_FLAGSHIP))
        wall, miou = counted_run('BiSeNetv2 Adam remat', flag)
        out['flagship_adam_remat'] = {'run_cold_s': wall, 'miou': miou}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out['remat'] = {name: _remat_pair(name, kw, dev)
                    for name, kw in REMAT_MODELS}

    # (c) the uint8 tail
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (B, TRAIN_H, TRAIN_W, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (B, TRAIN_H, TRAIN_W), dtype=np.int32)
    flags = rng.integers(0, 2, (B, 2), dtype=np.uint8)
    cpu_x, cpu_m = device_flip_norm(torch.from_numpy(u8),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(flags), *NORM_COEFFS)
    u8_d, labels_d, flags_d = (torch.from_numpy(a).to(dev)
                               for a in (u8, labels, flags))
    x, m = device_flip_norm(u8_d, labels_d, flags_d, *NORM_COEFFS)
    host_x, host_m = host_flip_norm(u8, labels, flags)
    check(torch.equal(x.cpu(), cpu_x) and torch.equal(m.cpu(), cpu_m),
          'device_flip_norm: the card differs from the CPU')
    check(np.array_equal(cpu_x.numpy(), host_x)
          and np.array_equal(cpu_m.numpy(), host_m),
          'device_flip_norm differs from the host path')
    flip_ms = time_ms(lambda: device_flip_norm(u8_d, labels_d, flags_d,
                                               *NORM_COEFFS), iters=10)
    del x, m
    pair = [SegTrainer(_train_config('unused', synthetic_len=B,
                                     total_epoch=1, save_ckpt=False,
                                     load_ckpt=False, **OPTIM_FLAGSHIP))
            for _ in range(2)]
    raw_step = build_train_step(pair[0].config, norm_coeffs=NORM_COEFFS)
    old = _deterministic(True)
    try:
        l_raw = raw_step(pair[0].state, u8_d, labels_d, flags_d)[1]['loss']
        l_host = pair[1].train_step(
            pair[1].state, torch.from_numpy(host_x).to(dev),
            torch.from_numpy(host_m).to(dev))[1]['loss']
    finally:
        _deterministic(old)
    check(torch.equal(l_raw, l_host), f'norm_coeffs step loss {l_raw} != '
          f'{l_host}')
    for x, y in ((pair[0].model, pair[1].model),
                 (pair[0].ema_model, pair[1].ema_model)):
        _same_weights(to_jax_variables(x), to_jax_variables(y))
    eval_u8 = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    eval_x, _ = host_flip_norm(eval_u8, np.zeros((B, 1, 1), np.int32),
                               np.zeros((B, 2), np.uint8))
    model = pair[0].ema_model
    raw_eval = build_eval_step(pair[0].config, model, dev, NORM_COEFFS)
    cm_raw, got = _counted(lambda: raw_eval(torch.from_numpy(eval_u8).to(
        dev), eval_msks))
    check(got == {'resize_argmax': 1, 'confusion_matrix': 1},
          f'eval step with norm_coeffs: launches {got}')
    for k, v in got.items():
        launches[k] += v
    cm_host = build_eval_step(pair[0].config, model, dev)(
        torch.from_numpy(eval_x).to(dev), eval_msks)
    check(torch.equal(cm_raw, cm_host), 'the eval step with norm_coeffs '
          'gives another confusion matrix than the float one')
    say(f'optim uint8 tail: device_flip_norm at {list(u8.shape)} with '
        f'random flags bit-equal on the card and the CPU and to the host '
        f'path, {flip_ms:.3f} ms on the card; BiSeNetv2 Adam step with '
        f'norm_coeffs on the uint8 batch: loss {float(l_raw)}, loss, '
        f'weights, BN statistics and EMA bit-equal to the float step on the '
        f'host-normalized batch (deterministic cuDNN); eval step at {H}x{W} '
        f'with norm_coeffs: confusion matrix equal to the float one\'s '
        f'(total {int(cm_raw.sum())}), launches {got}')
    out['uint8_tail'] = {'flip_norm_ms': flip_ms}
    del pair, model, raw_eval

    # (d) card against CPU, from the mapping check's draw
    out['card_vs_cpu'] = {}
    for name, kw, samples in OPTIM_CHECKS:
        variables = zoo_small_variables(kw, get_model(_train_config(
            'unused', **kw)))
        first, rel, weights = _zoo_card_vs_cpu(name, variables, kw, samples)
        out['card_vs_cpu'][name] = {'first_loss': first, 'loss': rel,
                                    'weights': weights}
    return launches, out


# ------------------------------------------------------------------ phase 7
_MOBILENET_V2_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                          (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                          (6, 320, 1, 1))


def torchvision_state_dict(backbone_type: str, seed: int) -> dict:
    """A state_dict under torchvision's names and shapes for 'resnet18'
    or 'mobilenet_v2', the classifier included, drawn from `seed`: conv
    and linear weights normal, BatchNorm weights, biases and running
    statistics uniform, so that no value repeats."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, out, cin, k):
        sd[name] = rng.normal(0, 0.1, (out, cin, k, k))

    def bn(name, c):
        sd[f'{name}.weight'] = rng.uniform(0.5, 1.5, c)
        sd[f'{name}.bias'] = rng.uniform(-0.5, 0.5, c)
        sd[f'{name}.running_mean'] = rng.uniform(-0.5, 0.5, c)
        sd[f'{name}.running_var'] = rng.uniform(0.5, 2.0, c)
        sd[f'{name}.num_batches_tracked'] = np.array(100, np.int64)

    if backbone_type == 'resnet18':
        conv('conv1.weight', 64, 3, 7)
        bn('bn1', 64)
        cin = 64
        for i, c in enumerate((64, 128, 256, 512), 1):
            for j in range(2):
                p = f'layer{i}.{j}'
                conv(f'{p}.conv1.weight', c, cin, 3)
                bn(f'{p}.bn1', c)
                conv(f'{p}.conv2.weight', c, c, 3)
                bn(f'{p}.bn2', c)
                if j == 0 and i > 1:
                    conv(f'{p}.downsample.0.weight', c, cin, 1)
                    bn(f'{p}.downsample.1', c)
                cin = c
        sd['fc.weight'] = rng.normal(0, 0.1, (1000, 512))
        sd['fc.bias'] = rng.uniform(-0.5, 0.5, 1000)
    elif backbone_type == 'mobilenet_v2':
        conv('features.0.0.weight', 32, 3, 3)
        bn('features.0.1', 32)
        cin, idx = 32, 1
        for t, c, n, _ in _MOBILENET_V2_SETTINGS:
            for _ in range(n):
                p, hid = f'features.{idx}.conv', cin * t
                if t == 1:
                    conv(f'{p}.0.0.weight', hid, 1, 3)
                    bn(f'{p}.0.1', hid)
                    conv(f'{p}.1.weight', c, hid, 1)
                    bn(f'{p}.2', c)
                else:
                    conv(f'{p}.0.0.weight', hid, cin, 1)
                    bn(f'{p}.0.1', hid)
                    conv(f'{p}.1.0.weight', hid, 1, 3)
                    bn(f'{p}.1.1', hid)
                    conv(f'{p}.2.weight', c, hid, 1)
                    bn(f'{p}.3', c)
                cin, idx = c, idx + 1
        conv('features.18.0.weight', 1280, 320, 1)
        bn('features.18.1', 1280)
        sd['classifier.1.weight'] = rng.normal(0, 0.1, (1000, 1280))
        sd['classifier.1.bias'] = rng.uniform(-0.5, 0.5, 1000)
    else:
        raise ValueError(f'no torchvision layout for {backbone_type}')
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if v.dtype == np.int64 else np.float32))
        for k, v in sd.items()}


def _by_value(tensors) -> dict:
    """{(shape, bytes): count} of float tensors, so that two collections
    can be compared as multisets of values whatever their names."""
    out: dict = {}
    for t in tensors:
        t = t.detach().float().cpu().contiguous()
        key = (tuple(t.shape), t.numpy().tobytes())
        out[key] = out.get(key, 0) + 1
    return out


# (model, torchvision layout) of the import phase: the scope is
# `backbone` in both
IMPORTS = (('swiftnet', 'resnet18'), ('liteseg', 'mobilenet_v2'))


def phase_import(dev):
    """config.backbone_ckpt on the card: a random torchvision-named
    state_dict for ResNet-18 and for MobileNetV2, written to a temp dir,
    imported by SegTrainer into SwiftNet and LiteSeg. The backbone's
    tensors, in the model and in its EMA, are the dict's feature tensors
    (as multisets of values: torchvision's and the port's convs share the
    OIHW layout; the classifier and BatchNorm's counters are not read),
    and every other leaf keeps the trainer's Flax init."""
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.train import SegTrainer
    from rtseg_tpu_torch.utils.convert import (_flatten, flax_init_variables,
                                               to_jax_variables)
    out = {}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_import_')
    try:
        for model, layout in IMPORTS:
            sd = torchvision_state_dict(layout, seed=2)
            path = str(Path(tmp) / f'{layout}.pth')
            torch.save(sd, path)
            features = _by_value(
                v for k, v in sd.items()
                if not k.startswith(('fc.', 'classifier.', 'features.18.'))
                and not k.endswith('num_batches_tracked'))
            cfg = _train_config(tmp, model=model, use_aux=False,
                                backbone_ckpt=path, backbone_type=layout,
                                save_ckpt=False, load_ckpt=False)
            t0 = time.perf_counter()
            trainer = SegTrainer(cfg)
            init_s = time.perf_counter() - t0
            start = dict(_flatten(flax_init_variables(get_model(cfg),
                                                      cfg.random_seed)))
            n_rest = 0
            for which, m in (('model', trainer.model),
                             ('EMA', trainer.ema_model)):
                check(next(m.parameters()).device.type == 'cuda',
                      f'import {model}: {which} is not on the card')
                held = _by_value(
                    v for k, v in m.state_dict().items()
                    if k.startswith('backbone.')
                    and not k.endswith('num_batches_tracked'))
                check(held == features,
                      f'import {model}: the {which}\'s backbone does not '
                      f'hold the {layout} dict\'s values')
                got = dict(_flatten(to_jax_variables(m)))
                rest = [k for k in start if k[1] != 'backbone']
                for k in rest:
                    check(np.array_equal(got[k], start[k]),
                          f'import {model}: {which} {"/".join(k)} moved')
                n_rest = len(rest)
            n = sum(features.values())
            say(f'import: {layout} state_dict ({len(sd)} tensors under '
                f'torchvision\'s names) into {model}\'s backbone on the card: '
                f'its {n} feature tensors are the backbone\'s, in the model '
                f'and its EMA; the other {n_rest} leaves keep the Flax init; '
                f'SegTrainer built in {init_s:.3f} s')
            out[model] = {'layout': layout, 'tensors': n,
                          'other_leaves': n_rest, 'init_s': init_s}
            del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------------ phase 8
def phase_times(dev, trainer, imgs, msks, preds, launches, wall, k1_err,
                k2_err, sass, k2_table):
    import torch.nn.functional as F
    from rtseg_tpu_torch.ops.fused_head import _argmax_ref, resize_argmax
    from rtseg_tpu_torch.ops.pallas_metrics import (confusion_matrix_pallas,
                                                    confusion_matrix_plain)
    from rtseg_tpu_torch.train.step import build_eval_step

    with torch.inference_mode():
        logits = trainer.model(imgs.to(torch.bfloat16), defer_upsample=True)
    logits = logits.contiguous()
    check(tuple(logits.shape) == (B, h, w, C), f'logits {logits.shape}')
    # K1: one kernel launch a call (the wrapper allocates the output)
    k1_ms = time_ms(lambda: resize_argmax(logits, (H, W)))
    k1_plain = time_ms(lambda: _argmax_ref(logits, (H, W)), iters=5)
    k1_lib = time_ms(lambda: F.interpolate(
        logits.permute(0, 3, 1, 2), (H, W), mode='bilinear',
        align_corners=True).argmax(1), iters=5)
    # bytes: logits in (bf16), int32 predictions out. operations: the two
    # taps of the W-interpolation (2 FMAs = 4 flops) at low height, then
    # per (pixel, class) one FMA (the H-lerp) and one compare
    k1_bytes = logits.numel() * 2 + B * H * W * 4
    k1_ops = B * h * C * W * 4 + B * H * W * C * 3
    k1_bound, k1_by = bound_ms(k1_bytes, k1_ops)
    # the formula of the earlier two-stage port (2 FMAs and a compare per
    # pixel and class), for comparison with its rows
    k1_bound_pr1, _ = bound_ms(k1_bytes,
                               B * h * C * W * 4 + B * H * W * C * 5)
    # what the time is made of: the same kernel at fewer and more classes
    # (random bf16 logits), each output checked against the float32 plain
    # version: the time at C=1 is the part every class count pays (bytes,
    # block set-up), the slope the cost of a class; C=20 runs in the
    # register bucket of 24, padded. All checks run before the timings
    g = torch.Generator(device=dev).manual_seed(2)
    x32 = torch.randn((B, h, w, 32), generator=g, device=dev
                      ).to(torch.bfloat16)
    xs = {c: x32[..., :c].contiguous() for c in (1, 8, C, 20, 24, 32)}
    del x32
    for c, xc in xs.items():
        rate = _rate(resize_argmax(xc, (H, W)),
                     _argmax_ref(xc.float(), (H, W)))
        say(f'K1 bf16 C={c} [{B},{h},{w},{c}] -> {H}x{W}: mismatch '
            f'{rate:.3e} against the float32 plain version (tolerance 1e-4)')
        check(rate <= 1e-4, f'K1 bf16 C={c} mismatch {rate}')
    by_c = {c: time_ms(lambda xc=xc: resize_argmax(xc, (H, W)))
            for c, xc in xs.items()}
    del xs
    # the 1/4-resolution logits of ICNet, SwiftNet, FarSeeNet and ShelfNet
    # (random bf16, checked against the float32 plain version): 4x the
    # bytes in, the same out
    xq = torch.randn((B, H // 4, W // 4, C), generator=g, device=dev
                     ).to(torch.bfloat16)
    q_rate = _rate(resize_argmax(xq, (H, W)),
                   _argmax_ref(xq.float(), (H, W)))
    check(q_rate <= 1e-4, f'K1 1/4 resolution mismatch {q_rate}')
    q_ms = time_ms(lambda: resize_argmax(xq, (H, W)))
    q_plain = time_ms(lambda: _argmax_ref(xq, (H, W)), iters=5)
    q_lib = time_ms(lambda: F.interpolate(
        xq.permute(0, 3, 1, 2), (H, W), mode='bilinear',
        align_corners=True).argmax(1), iters=5)
    q_bound, q_by = bound_ms(xq.numel() * 2 + B * H * W * 4,
                             B * (H // 4) * C * W * 4 + B * H * W * C * 3)
    del xq
    # MiniNetv2's 1/2-resolution logits: 16x the bytes in of 1/8, the same
    # out, and one band about every two output rows
    xh = torch.randn((B, H // 2, W // 2, C), generator=g, device=dev
                     ).to(torch.bfloat16)
    s2_rate = _rate(resize_argmax(xh, (H, W)),
                    _argmax_ref(xh.float(), (H, W)))
    check(s2_rate <= 1e-4, f'K1 output stride 2 mismatch {s2_rate}')
    s2_ms = time_ms(lambda: resize_argmax(xh, (H, W)))
    s2_plain = time_ms(lambda: _argmax_ref(xh, (H, W)), iters=5)
    s2_lib = time_ms(lambda: F.interpolate(
        xh.permute(0, 3, 1, 2), (H, W), mode='bilinear',
        align_corners=True).argmax(1), iters=5)
    s2_bound, s2_by = bound_ms(xh.numel() * 2 + B * H * W * 4,
                               B * (H // 2) * C * W * 4 + B * H * W * C * 3)
    del xh

    k2_ms = time_ms(lambda: confusion_matrix_pallas(preds, msks, C, IGNORE))
    k2_plain = time_ms(lambda: confusion_matrix_plain(preds, msks, C, IGNORE),
                       iters=5)
    t, p = msks.reshape(-1).long(), preds.reshape(-1).long()
    ok = (t != IGNORE) & (t >= 0) & (t < C) & (p >= 0) & (p < C)
    keys = (t * C + p)[ok]
    k2_lib = time_ms(lambda: torch.bincount(keys, minlength=C * C), iters=5)
    k2_bound, k2_by = bound_ms(preds.numel() * 4 + msks.numel() * 4,
                               preds.numel())

    step = build_eval_step(trainer.config, trainer.model, dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: trainer.model(imgs.to(torch.bfloat16),
                                               defer_upsample=True), iters=5)
    step_ms = time_ms(lambda: step(imgs, msks), iters=5)
    say(f'times (ms): K1 {k1_ms:.4f}, plain {k1_plain:.4f}, F.interpolate+'
        f'argmax {k1_lib:.4f}, bound {k1_bound:.4f} ({k1_by}), '
        f'{k1_bound / k1_ms:.1%} of the bound reached (the earlier '
        f'formula, 5 flops a pixel and class: {k1_bound_pr1:.4f})')
    say(f'times (ms): K1 at 1/4 resolution [{B},{H // 4},{W // 4},{C}] '
        f'bf16 -> {H}x{W}: {q_ms:.4f}, plain {q_plain:.4f}, F.interpolate+'
        f'argmax {q_lib:.4f}, bound {q_bound:.4f} ({q_by}), '
        f'{q_bound / q_ms:.1%} of the bound reached (mismatch {q_rate:.3e} '
        f'against the float32 plain version)')
    say(f'times (ms): K1 at output stride 2 [{B},{H // 2},{W // 2},{C}] '
        f'bf16 -> {H}x{W}: {s2_ms:.4f}, plain {s2_plain:.4f}, F.interpolate+'
        f'argmax {s2_lib:.4f}, bound {s2_bound:.4f} ({s2_by}), '
        f'{s2_bound / s2_ms:.1%} of the bound reached (mismatch '
        f'{s2_rate:.3e} against the float32 plain version)')
    say(f'times (ms): K1 by class count at [{B},{h},{w},C] -> {H}x{W}: '
        + ', '.join(f'C={c} {t:.4f}' for c, t in by_c.items())
        + f'; {(by_c[C] - by_c[8]) / (C - 8) * 1e3:.2f} us a class from C=8 '
        f'to {C}')
    if sass:
        # an estimate, not a reading of the card's counters: the row loop's
        # warp instructions at one a clock on each scheduler (4 an SM) at
        # the card's maximum SM clock
        mhz = float(subprocess.run(
            ['nvidia-smi', '--query-gpu=clocks.max.sm',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=60).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        issue_ms = (B * H * W / 32 * sass['instructions_per_row']
                    / (sms * 4 * mhz * 1e6) * 1e3)
        sass.update(issue_ms=issue_ms, sm_clock_mhz=mhz, sms=sms)
        say(f'K1 row loop at the issue rate ({sms} SMs x 4 schedulers, '
            f'{mhz:g} MHz max SM clock): {issue_ms:.4f} ms for the rows '
            f'alone, {issue_ms / k1_ms:.1%} of K1\'s time (an estimate from '
            f'the SASS count)')
    say(f'times (ms): K2 {k2_ms:.4f}, plain {k2_plain:.4f}, torch.bincount '
        f'{k2_lib:.4f}, bound {k2_bound:.4f} ({k2_by}), '
        f'{k2_bound / k2_ms:.1%} of the bound reached')
    n_batches = len(trainer.val_loader)
    say(f'slice eval step on a resident batch: {step_ms:.3f} ms = '
        f'{B / step_ms * 1e3:.2f} imgs/s (model forward {fwd_ms:.3f} ms, '
        f'K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms); validate() kept the card '
        f'busy about {n_batches * step_ms / (wall * 1e3):.3f} of its wall '
        f'time (batches x resident step time / wall)')
    return [
        {'name': 'resize_argmax', 'route': 'cuda',
         'source': 'rtseg_tpu_torch/ops/csrc/fused_head.cu',
         'replaces': 'rtseg_tpu/ops/fused_head.py:138',
         'launches': launches['resize_argmax'],
         'max_abs_err': k1_err['float32'][1],
         'mismatch_float32': k1_err['float32'][0],
         'mismatch_bfloat16': k1_err['bfloat16'][0],
         'mismatch_bfloat16_vs_float32': k1_err['bfloat16_vs_float32'],
         'ms': k1_ms, 'plain_ms': k1_plain, 'bound_ms': k1_bound,
         'bound_by': k1_by, 'library_ms': k1_lib,
         'bound_ms_pr1_formula': k1_bound_pr1, 'ms_by_classes': by_c,
         'quarter_res': {'shape': [B, H // 4, W // 4, C], 'ms': q_ms,
                         'plain_ms': q_plain, 'library_ms': q_lib,
                         'bound_ms': q_bound, 'bound_by': q_by,
                         'mismatch_bfloat16_vs_float32': q_rate},
         'half_res': {'shape': [B, H // 2, W // 2, C], 'ms': s2_ms,
                      'plain_ms': s2_plain, 'library_ms': s2_lib,
                      'bound_ms': s2_bound, 'bound_by': s2_by,
                      'mismatch_bfloat16_vs_float32': s2_rate},
         'sass_row_loop': sass},
        {'name': 'confusion_matrix_pallas', 'route': 'cuda',
         'source': 'rtseg_tpu_torch/ops/csrc/confusion_matrix.cu',
         'replaces': 'rtseg_tpu/ops/pallas_metrics.py:66',
         'launches': launches['confusion_matrix'],
         'max_abs_err': k2_err, 'ms': k2_ms, 'plain_ms': k2_plain,
         'bound_ms': k2_bound, 'bound_by': k2_by, 'library_ms': k2_lib,
         **k2_table},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 2
    # the port's package comes from the checkout; without it, stop here
    # before anything is printed
    import rtseg_tpu_torch  # noqa: F401
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    start = time.perf_counter()

    def elapsed(phase):
        say(f'elapsed {time.perf_counter() - start:.1f} s at the end of '
            f'phase {phase}')

    card, sass = phase_card_and_build()
    k1_err = phase_k1(dev)
    k2_err, k2_table = phase_k2(dev)
    elapsed('1-3 (build, K1, K2)')
    trainer, imgs, msks, preds, launches, wall = phase_slice(dev)
    elapsed('4 (eval slice)')
    train_launches, train = phase_train(dev, card)
    elapsed('5 (train)')
    zoo_launches, zoo = phase_zoo(dev, card, imgs, msks)
    elapsed('6 (zoo)')
    kd_launches, kd = phase_kd(dev, card, imgs, msks)
    elapsed('6b (KD)')
    optim_launches, optim = phase_optim(dev, card, imgs, msks)
    elapsed('6c (optimizer tail)')
    imports = phase_import(dev)
    launches = {k: v + train_launches[k] + zoo_launches[k] + kd_launches[k]
                + optim_launches[k] for k, v in launches.items()}
    # one a val batch: 3 in the eval slice, 3 in the train run, 2 for each
    # zoo model (K1 only for those with low-resolution logits), 2 each for
    # the KD teacher's and student's runs (DeepLabV3+: 1/4 logits), 2 each
    # for the MiT-b2 AdamW and the BiSeNetv2 Adam runs and 1 for the eval
    # step with norm_coeffs
    want = {'resize_argmax': 15 + 2 * sum(s > 1 for _, _, s, _ in ZOO),
            'confusion_matrix': 15 + 2 * len(ZOO)}
    check(launches == want, f'launch counts {launches} != {want}')
    kernels = phase_times(dev, trainer, imgs, msks, preds, launches, wall,
                          k1_err, k2_err, sass, k2_table)
    elapsed('7-8 (import, times)')
    say(json.dumps({'train': train}))
    say(json.dumps({'zoo': zoo}))
    say(json.dumps({'kd': kd}))
    say(json.dumps({'optim': optim}))
    say(json.dumps({'import': imports}))
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
