#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels (nvcc, sm_90a);
     count the SASS instructions of K1's row loop (cuobjdump)
  2. K1 (fused upsample+argmax) against its plain version at the slice's
     shapes, [16,128,256,19] -> 1024x2048, in float32 and bfloat16 (and
     bf16 logits against the float32 plain version), plus integer logits,
     all-equal logits, the identity size, and in float32 and bfloat16
     W=2050, align_corners=False, a downsample, an odd shape, C=1, C=150
  3. K2 (confusion matrix) against its plain version: bit-equal
  4. the slice: SegTrainer(cfg).validate() of BiSeNetv2 (aux heads, 19
     classes, bf16) on synthetic 1024x2048 data, bs16, 3 batches, with the
     kernels' launch counts read around the run; build_predict_step once;
     and the eval step on the card against the CPU path on a small input
  5. times (CUDA events after warm-up) of each kernel, its plain version
     and a one-call library yardstick, beside the bound and the share of
     it reached; K1 at several class counts (each checked); the slice's
     imgs/s; K1's row loop at the issue rate, from its SASS (phase 1)
  6. the {"kernels": [...]} line; 7. the {"ok": true, ...} line.

Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

B, h, w, C = 16, 128, 256, 19          # deferred BiSeNetv2 logits
H, W = 1024, 2048                      # Cityscapes val shape
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
    say(f'card: {smi.stdout.strip().splitlines()[0]}')
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
    return _sass_row_loop(cuda_build)


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
    xs = x[:2].contiguous()
    for name, xin, size, corners in (
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
def phase_k2(dev):
    from rtseg_tpu_torch.ops.pallas_metrics import (confusion_matrix_pallas,
                                                    confusion_matrix_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (B, H, W)
    preds = torch.randint(0, C + 2, shape, generator=g, device=dev,
                          dtype=torch.int32)          # some preds >= C
    labels = torch.randint(-1, C + 2, shape, generator=g, device=dev,
                           dtype=torch.int32)         # -1 and >= C drop
    drop = torch.rand(shape, generator=g, device=dev) < 0.1
    labels = torch.where(drop, torch.full_like(labels, IGNORE), labels)
    err = 0
    for lab in (labels, labels.long()):
        got = confusion_matrix_pallas(preds, lab, C, IGNORE)
        ref = confusion_matrix_plain(preds, lab, C, IGNORE)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and got.shape == (C, C),
              f'K2 output {got.dtype} {tuple(got.shape)}')
        err = max(err, int((got.long() - ref.long()).abs().max()))
        check(torch.equal(got, ref), f'K2 differs from bincount ({lab.dtype})')
    say(f'K2 random/ignored/out-of-range ({labels.numel()} px, int32 and '
        f'int64 labels): bit-equal, total {int(got.sum())}')
    same = torch.zeros(shape, dtype=torch.int32, device=dev)
    got = confusion_matrix_pallas(same, same, C, IGNORE)
    check(torch.equal(got, confusion_matrix_plain(same, same, C, IGNORE)),
          'K2 differs from bincount on one full cell')
    check(int(got[0, 0]) == same.numel() > 2 ** 24,
          f'K2 cell count {int(got[0, 0])} != {same.numel()}')
    say(f'K2 one cell of {int(got[0, 0])} > 2^24 counts: bit-equal')
    return err


# ------------------------------------------------------------------ phase 4
def _slice_config(**kw):
    from rtseg_tpu_torch.config import SegConfig
    base = dict(model='bisenetv2', use_aux=True, num_class=C,
                dataset='synthetic', crop_h=H, crop_w=W, val_bs=B,
                synthetic_len=4 * 3 * B,          # val split: 3 batches
                compute_dtype='bfloat16', random_seed=1)
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
    small = dict(crop_h=64, crop_w=128, val_bs=2, synthetic_len=8,
                 compute_dtype='float32')
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
def phase_times(dev, trainer, imgs, msks, preds, launches, wall, k1_err,
                k2_err, sass):
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
         'sass_row_loop': sass},
        {'name': 'confusion_matrix_pallas', 'route': 'cuda',
         'source': 'rtseg_tpu_torch/ops/csrc/confusion_matrix.cu',
         'replaces': 'rtseg_tpu/ops/pallas_metrics.py:66',
         'launches': launches['confusion_matrix'],
         'max_abs_err': k2_err, 'ms': k2_ms, 'plain_ms': k2_plain,
         'bound_ms': k2_bound, 'bound_by': k2_by, 'library_ms': k2_lib},
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
    sass = phase_card_and_build()
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    kernels = phase_times(dev, *phase_slice(dev), k1_err, k2_err, sass)
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
