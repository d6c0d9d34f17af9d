"""Rank workers of the port's data-parallel tests (test_torch_parallel.py,
test_torch_ddp_step.py, test_torch_ddp_trainer.py).

`start(target, world, tmp_path, ...)` starts one spawned process a rank;
each joins its process group itself (a gloo group through a file:// store
under tmp_path, or the torchrun environment or `multihost` a test names),
runs `target(rank, world, store, **kw)` from this module and writes what
it returns with torch.save; `Ranks.results()` waits for them (with a
timeout) and raises with a rank's traceback. The module imports no JAX,
so the children start fast.

Run as a script, it prints how far 2 ranks stray from one process at
the global batch, step by step, in float32 and float64 (`main_drift`):

    python tests/_torch_ddp_worker.py --lr 1e-3 1e-2
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# BiSeNetv2 with its aux heads and OHEM at 64x128 under SGD OneCycle with
# EMA: a global batch of 4 a step (2 ranks x 2), 1 step an epoch, peak LR
# 1e-3 for 2 devices (base_lr 5e-4 x 2)
STEP_KW = dict(model='bisenetv2', use_aux=True, num_class=19,
               dataset='synthetic', crop_h=64, crop_w=128, train_bs=2,
               val_bs=2, synthetic_len=4, total_epoch=2, warmup_epochs=1,
               lr_policy='cos_warmup', optimizer_type='sgd',
               loss_type='ohem', use_ema=True, compute_dtype='float32',
               random_seed=3, base_lr=5e-4, use_tb=False, use_obs=False,
               base_workers=0, load_ckpt=False, save_ckpt=False)


def free_port() -> int:
    """A TCP port of localhost that is free now (for env:// and tcp://
    rendezvous; no fixed port)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def join(store: str, rank: int, world: int) -> None:
    """Join the gloo group of `world` ranks at the file store `store`."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=world)


def _main(target: str, rank: int, world: int, store: str, out: str,
          env: Optional[dict], kw: dict) -> None:
    os.environ.update(env or {})
    torch.set_num_threads(1)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        result = {'ok': globals()[target](rank, world, store, **kw)}
    except Exception:
        result = {'error': traceback.format_exc()}
    finally:
        from rtseg_tpu_torch.parallel import close
        try:
            close()
        except Exception:
            pass
    torch.save(result, out)


class Ranks:
    def __init__(self, procs, outs, timeout):
        self.procs, self.outs, self.timeout = procs, outs, timeout

    def results(self) -> List:
        """Each rank's return value, in rank order."""
        import time
        deadline = time.monotonic() + self.timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert not hung, f'ranks {hung} did not end within {self.timeout} s'
        out = []
        for r, path in enumerate(self.outs):
            assert os.path.exists(path), (
                f'rank {r} exited with {self.procs[r].exitcode} and no result')
            res = torch.load(path, weights_only=False)
            assert 'error' not in res, f'rank {r}:\n{res["error"]}'
            out.append(res['ok'])
        return out


def start(target: str, world: int, tmp_path,
          envs: Optional[List[dict]] = None, timeout: float = 300.0,
          **kw) -> Ranks:
    """Start `world` spawned ranks running `target`; `envs[r]`, where
    given, goes into rank r's environment first."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    base = tempfile.mkdtemp(prefix='ddp_', dir=str(tmp_path))
    store = os.path.join(base, 'store')
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(base, f'rank{r}.pt')
        p = ctx.Process(target=_main, args=(
            target, r, world, store, out, envs[r] if envs else None, kw),
            daemon=True)
        p.start()
        procs.append(p)
        outs.append(out)
    return Ranks(procs, outs, timeout)


def run(target: str, world: int, tmp_path, **kw) -> List:
    return start(target, world, tmp_path, **kw).results()


# ------------------------------------------------------------ rendezvous

def rendezvous(rank, world, store, how: str, port: int) -> Dict:
    """Open the group as `how` asks (the torchrun environment, or
    multihost with a coordinator) through SegTrainer's own call, and
    read it back."""
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.parallel import (all_reduce_mean, all_reduce_sum,
                                          backend, barrier, init_multihost,
                                          local_device, main_rank,
                                          process_count, process_index)
    cfg = SegConfig()
    if how == 'multihost':
        cfg = SegConfig(multihost=True,
                        coordinator_address=f'127.0.0.1:{port}',
                        process_id=rank, num_processes=world)
    opened = init_multihost(cfg, 'cpu')
    total = all_reduce_sum(torch.tensor([rank + 1], dtype=torch.int64))
    mean = all_reduce_mean(torch.tensor([float(rank)]))
    barrier()
    # prediction runs in one process
    from rtseg_tpu_torch.train import SegTrainer
    try:
        SegTrainer(SegConfig(is_testing=True, save_dir=os.path.join(
            os.path.dirname(store), f'predict{rank}')), device='cpu')
        refused = ''
    except ValueError as e:
        refused = str(e)
    # the card main_torch.py's `--device cuda:K` names for this process
    import main_torch
    given = local_device(main_torch.split_device(['--device',
                                                  f'cuda:{rank}'])[0])
    return dict(opened=opened, count=process_count(), index=process_index(),
                main=main_rank(), backend=backend(), total=int(total),
                mean=float(mean), device=str(local_device()),
                given=str(given),
                again=init_multihost(cfg, 'cpu'), predict_refused=refused)


# ------------------------------------------------------------- the steps

def obs_sink(rank, world, store, obs_dir: str) -> Dict:
    """Open this rank's event sink (obs/core.py init_run) in a gloo group
    and write one event: each rank's file is its own. The ranks leave
    together (a rank that tore its group down while the other was still
    connecting would fail that one)."""
    import torch.distributed as dist
    from rtseg_tpu_torch.obs import init_run
    join(store, rank, world)
    sink = init_run(obs_dir, meta={'rank': rank})
    sink.emit({'event': 'probe', 'rank': rank})
    sink.close()
    dist.barrier()
    return {'path': sink.path, 'host': sink.static['host']}


def _state(cfg, variables, dtype=torch.float32):
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.train.optim import get_optimizer
    from rtseg_tpu_torch.train.state import TrainState, make_ema_model
    from rtseg_tpu_torch.utils.convert import load_jax_variables
    model = get_model(cfg)
    load_jax_variables(model, variables)
    model = model.to(dtype)
    return TrainState(step=0, model=model,
                      optimizer=get_optimizer(cfg, model.parameters()),
                      ema_model=make_ema_model(model))


def _config(world, **kw):
    from rtseg_tpu_torch.config import SegConfig
    cfg = SegConfig(**{**STEP_KW, **kw})
    cfg.resolve(num_devices=world)
    cfg.resolve_schedule(cfg.synthetic_len)
    return cfg


def _steps(cfg, variables, batches, dtype=torch.float32,
           trail: bool = False) -> Dict:
    """The port's train step over `batches` (this rank's slices) from
    `variables`: per-step (local) losses, the weights and the EMA (and,
    with `trail`, both after each step)."""
    from rtseg_tpu_torch.train import build_train_step
    from rtseg_tpu_torch.train import step as step_mod
    from rtseg_tpu_torch.utils.convert import to_jax_variables
    state = _state(cfg, variables, dtype)
    named = step_mod.compute_dtype
    if dtype == torch.float64:
        # the forward in float64 (the losses keep their float32 softmax)
        step_mod.compute_dtype = lambda config: torch.float64
    try:
        step = build_train_step(cfg)
        losses, after = [], []
        for imgs, msks in batches:
            state, m = step(state, torch.from_numpy(imgs).to(dtype),
                            torch.from_numpy(msks))
            losses.append(float(m['loss']))
            if trail:
                after.append(_copy(dict(
                    variables=to_jax_variables(state.model),
                    ema=to_jax_variables(state.ema_model))))
    finally:
        step_mod.compute_dtype = named
    return dict(losses=losses, step=state.step, trail=after,
                variables=to_jax_variables(state.model),
                ema=to_jax_variables(state.ema_model))


def _slices(batches, rank, world):
    out = []
    for imgs, msks in batches:
        b = imgs.shape[0] // world
        out.append((imgs[rank * b:(rank + 1) * b],
                    msks[rank * b:(rank + 1) * b]))
    return out


def ddp_steps(rank, world, store, variables, batches, forward_x) -> Dict:
    """For test_torch_ddp_step.py: rank 0 first runs the float64 steps in
    one process at the global batch (no group); then every rank joins the
    group and runs 3 steps with sync_bn on (float32, float64) and off
    (float32, float64), and the float32 training forward of its slice of
    `forward_x` with synced statistics, each on its slice of the global
    batches."""
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.nn import batch_norms, sync_batch_norm
    from rtseg_tpu_torch.parallel import all_reduce_mean_grad
    from rtseg_tpu_torch.utils.convert import (load_jax_variables,
                                               to_jax_variables)
    out = {}
    if rank == 0:
        out['one_process64'] = _steps(
            _config(1, train_bs=2 * world,
                    base_lr=STEP_KW['base_lr'] * world),
            variables, batches, torch.float64)
    join(store, rank, world)
    mine = _slices(batches, rank, world)
    for sync in (True, False):
        for dtype in (torch.float32, torch.float64):
            out[sync, dtype] = _steps(_config(world, sync_bn=sync),
                                      variables, mine, dtype)
    cfg = _config(world)
    model = get_model(cfg)
    load_jax_variables(model, variables)
    b = forward_x.shape[0] // world
    x = torch.from_numpy(forward_x[rank * b:(rank + 1) * b])
    with torch.no_grad(), sync_batch_norm(batch_norms(model),
                                          all_reduce_mean_grad):
        logits, aux = model.train()(x)
    out['forward'] = dict(logits=logits.numpy(),
                          aux=[a.numpy() for a in aux],
                          batch_stats=to_jax_variables(model)['batch_stats'])
    return out


def drift(rank, world, store, variables, batches, lrs, dtypes) -> Dict:
    """For `python tests/_torch_ddp_worker.py`: under sync_bn, at each
    peak LR of `lrs` and in each dtype, rank 0 first runs the steps in
    one process at the global batch (no group); then every rank joins
    the group and runs them on its slice. Weights and EMA after each
    step, {(lr, dtype): (one process's, this rank's)}."""
    runs = {}
    kw = dict(synthetic_len=4 * len(batches), sync_bn=True)
    if rank == 0:
        for lr in lrs:
            for dtype in dtypes:
                runs[lr, dtype] = _steps(
                    _config(1, train_bs=2 * world, base_lr=lr, **kw),
                    variables, batches, dtype, trail=True)['trail']
    join(store, rank, world)
    mine = _slices(batches, rank, world)
    out = {}
    for lr in lrs:
        for dtype in dtypes:
            ranked = _steps(_config(world, base_lr=lr / world, **kw),
                            variables, mine, dtype, trail=True)['trail']
            out[lr, dtype] = (runs.get((lr, dtype)), ranked)
    return out


def one_rank_group(rank, world, store, variables, batches) -> Dict:
    """The same steps, without and with remat, first without a group and
    then in a gloo group of one rank (sync_bn on, so every collective
    runs); {remat: the losses of both and the leaves that differ}."""
    import torch.distributed as dist
    configs = {remat: _config(1, train_bs=4, remat=remat, base_lr=1e-3)
               for remat in (False, True)}
    alone = {k: _steps(cfg, variables, batches) for k, cfg in configs.items()}
    join(store, rank, world)
    assert dist.get_world_size() == 1
    grouped = {k: _steps(cfg, variables, batches)
               for k, cfg in configs.items()}

    def flat(run):
        for what in ('variables', 'ema'):
            yield from _flat(run[what], what)
    out = {}
    for k in configs:
        differ = [n for (n, a), (_, b) in zip(flat(alone[k]),
                                              flat(grouped[k]))
                  if not np.array_equal(a, b)]
        out[k] = dict(losses=(alone[k]['losses'], grouped[k]['losses']),
                      differ=differ)
    return out


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}/{k}')
        else:
            yield f'{prefix}/{k}', np.asarray(v)


# ----------------------------------------------------------- the trainer

def _copy(tree) -> dict:
    """A copy of a variable tree whose arrays may view live tensors."""
    return {k: _copy(v) if isinstance(v, dict) else np.array(v, copy=True)
            for k, v in tree.items()}


def ddp_trainer(rank, world, store, kw, variables, epochs) -> Dict:
    """For test_torch_ddp_trainer.py: SegTrainer(cfg).run() for
    epochs[0] epochs, then a fresh trainer that resumes last.ckpt to
    epochs[1]; what each wrote, its losses, mIoUs, matrices and
    weights."""
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.train import SegTrainer
    from rtseg_tpu_torch.train import trainer as trainer_mod
    from rtseg_tpu_torch.utils.convert import to_jax_variables
    join(store, rank, world)
    writes = []
    for name in ('write_train_ckpt', 'write_best_ckpt'):
        def counted(*a, _name=name, _fn=getattr(trainer_mod, name)):
            writes.append(_name)
            return _fn(*a)
        setattr(trainer_mod, name, counted)
    runs = []
    for i, total in enumerate(epochs):
        t = SegTrainer(SegConfig(**kw, total_epoch=total), device='cpu',
                       variables=variables if i == 0 else None)
        start = t.cur_epoch
        start_model = _copy(to_jax_variables(t.model))
        score = t.run()
        runs.append(dict(start=start, start_model=start_model,
                         score=score, losses=t.epoch_losses,
                         best=t.best_score, history=t.val_history,
                         cm=t.last_cm, step=t.state.step,
                         gpu_num=t.config.gpu_num, lr=t.config.lr,
                         total_itrs=t.config.total_itrs,
                         model=to_jax_variables(t.model),
                         ema=to_jax_variables(t.ema_model)))
    return dict(runs=runs, writes=writes)


def main_torch_run(rank, world, store, argv) -> Dict:
    """main_torch.main(argv) in the environment a launcher gives the rank
    (the test's envs)."""
    import main_torch
    from rtseg_tpu_torch.parallel import process_count, process_index
    trainer, score = main_torch.main(argv)
    return dict(count=process_count(), index=process_index(), score=score,
                losses=trainer.epoch_losses, step=trainer.state.step,
                device=str(trainer.device), gpu_num=trainer.config.gpu_num,
                train_loader=(trainer.train_loader.process_index,
                              trainer.train_loader.process_count))


def _apart(a, b) -> float:
    """The largest |a - b| over two variable trees (the distance
    chip_smoke's `_same_weights` reports)."""
    return max(float(np.abs(x - y).max())
               for (_, x), (_, y) in zip(_flat(a), _flat(b)))


def main_drift(argv=None) -> None:
    """How far 2 gloo ranks x 2 samples stray from one process of 4 on
    the CPU, step by step (BiSeNetv2 with aux heads and OHEM at 64x128,
    sync_bn, SGD OneCycle with EMA, 3 steps of distinct samples: the
    float32 check of chip_smoke's phase 12), at each peak LR, in float32
    and float64; prints one line a (LR, dtype)."""
    import argparse
    import multiprocessing as mp
    p = argparse.ArgumentParser(description=main_drift.__doc__)
    p.add_argument('--lr', type=float, nargs='+', default=[1e-3, 1e-2])
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from rtseg_tpu_torch.models import get_model
    from rtseg_tpu_torch.utils.convert import random_jax_variables
    cfg = _config(1)
    variables = random_jax_variables(get_model(cfg), seed=args.seed)
    rng = np.random.default_rng(args.seed)
    batches = [(rng.standard_normal((4, 64, 128, 3)).astype(np.float32),
                rng.integers(0, 19, (4, 64, 128)).astype(np.int32))
               for _ in range(3)]
    dtypes = (torch.float32, torch.float64)
    mp.set_start_method('spawn', force=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run('drift', 2, tmp, variables=variables, batches=batches,
                    lrs=args.lr, dtypes=dtypes, timeout=900)
    for lr in args.lr:
        for dtype in dtypes:
            one, r0 = ranks[0][lr, dtype]
            steps = [max(_apart(a['variables'], b['variables']),
                         _apart(a['ema'], b['ema']))
                     for a, b in zip(r0, one)]
            ranks_apart = max(
                _apart(x['variables'], y['variables'])
                for x, y in zip(r0, ranks[1][lr, dtype][1]))
            print(f'peak LR {lr:g} {str(dtype)[6:]}: 2 ranks x 2 against one '
                  f'process x 4, weights and EMA apart after each step '
                  f'{["%.3e" % d for d in steps]}; the ranks '
                  f'{ranks_apart:.3e} apart')


if __name__ == '__main__':
    main_drift()
