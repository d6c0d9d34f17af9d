"""SegTrainer.run() with the JAX package's defaults for use_tb and use_obs,
on the CPU, against one module-scoped JAX run of the same config
(FastSCNN, crop 32, 2 epochs, val_interval 1; the JAX run's per-device
batch times its devices is the port's batch, so both take the same
steps).

The port's event stream (save_dir/segscope/events-000.jsonl) has the JAX
stream's event kinds and, kind by kind, its keys; the JAX package's
summarize reads it and gives what the port's gives; the port's
tools/torch_segscope.py reports it with exit 0; both runs write the same
TensorBoard tags at the same steps."""

import collections
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from rtseg_tpu.config import SegConfig as JaxConfig
from rtseg_tpu.obs import report as jreport
from rtseg_tpu.train import SegTrainer as JaxTrainer
from rtseg_tpu.train import trainer as jax_trainer_mod
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.obs import report as treport
from rtseg_tpu_torch.train import SegTrainer

from test_torch_obs_collector import _tb_triples as _tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dataset='synthetic', model='fastscnn', num_class=5, crop_size=32,
          total_epoch=2, val_interval=1, compute_dtype='float32',
          base_workers=0, log_interval=1, load_ckpt=False, save_ckpt=False,
          synthetic_len=16)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(save_dir):
    return [json.loads(line) for line in
            open(os.path.join(save_dir, 'segscope', 'events-000.jsonl'))]


def _kinds(events):
    """(event, kind, span name) -> the union of the keys seen."""
    out = collections.defaultdict(set)
    for e in events:
        out[(e['event'], e.get('kind'), e.get('name'))] |= set(e)
    return dict(out)


def _jitted_init(create):
    """create_train_state with the model's init under one jax.jit: the
    JAX trainer's eager init compiles each op of the model on its own,
    most of this file's time; nothing here reads the weights."""
    def fast(model, optimizer, rng, sample_input):
        init = jax.jit(model.init, static_argnums=2)
        return create(types.SimpleNamespace(init=init), optimizer, rng,
                      sample_input)
    return fast


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    save = str(tmp_path_factory.mktemp('jax_run'))
    cfg = JaxConfig(**KW, train_bs=1, val_bs=1, save_dir=save)
    cfg.resolve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_mod, 'create_train_state',
                   _jitted_init(jax_trainer_mod.create_train_state))
        JaxTrainer(cfg).run()
    return save, jax.device_count()


@pytest.fixture(scope='module')
def port_run(tmp_path_factory, jax_run):
    save = str(tmp_path_factory.mktemp('port_run'))
    n = jax_run[1]
    cfg = SegConfig(**KW, train_bs=n, val_bs=n, save_dir=save)
    assert cfg.use_tb and cfg.use_obs          # the JAX package's defaults
    cfg.resolve()
    trainer = SegTrainer(cfg, device='cpu')
    score = trainer.run()
    return save, trainer, score


def test_event_stream_has_the_jax_kinds_and_keys(jax_run, port_run):
    jev, tev = _events(jax_run[0]), _events(port_run[0])
    assert _kinds(tev) == _kinds(jev)
    # the same steps, the first train and the first val step flagged
    # compile (a new input signature, where JAX compiles)
    def steps(ev):
        return [(e['kind'], e.get('compile', False)) for e in ev
                if e['event'] == 'step']
    assert steps(tev) == steps(jev)
    assert steps(tev)[0] == ('train', True) and ('val', True) in steps(tev)
    assert [e['event'] for e in tev][0] == 'run_start'
    assert [e['event'] for e in tev][-1] == 'run_end'
    # the trainer's threads and sink are gone with run()
    trainer = port_run[1]
    assert trainer._obs_sink is None and trainer._watchdog is None
    assert trainer.writer is None


def test_jax_summarize_reads_the_port_stream(port_run):
    events = treport.load_events(os.path.join(port_run[0], 'segscope'))
    a, b = treport.summarize(events), jreport.summarize(events)
    assert a == b
    assert a['train_steps'] == 4 and a['epochs'] == 2
    assert a['compile_steps'] == 2 and a['stalls'] == 0
    assert a['goodput'] > 0 and a['wall_s'] > 0
    assert a['spans']['data/h2d']['count'] == a['train_steps'] + \
        a['val_steps']
    assert treport.format_summary(a) == jreport.format_summary(b)


def test_segscope_report_exits_0_on_the_run(port_run):
    obs_dir = os.path.join(port_run[0], 'segscope')
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, 'tools', 'torch_segscope.py'),
                        'report', obs_dir, '--check'],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert 'segscope check OK' in r.stdout and 'goodput' in r.stdout


def test_tensorboard_tags_and_steps_match_jax(jax_run, port_run):
    cfg = port_run[1].config
    port = _tb(cfg.tb_log_dir)
    jax_ = _tb(os.path.join(jax_run[0], 'tb_logs'))
    assert sorted((t, s) for t, s, _ in port) == sorted(
        (t, s) for t, s, _ in jax_)
    tags = {t for t, _, _ in port}
    assert {'train/loss', 'val/mIoU', 'val/IoU_cls00'} <= tags
    # the logged mIoU is the run's
    miou = [v for t, s, v in port if t == 'val/mIoU']
    assert miou[-1] == pytest.approx(port_run[1].val_history[-1][1],
                                     rel=1e-6)
    losses = [v for t, _, v in port if t == 'train/loss']
    assert np.isfinite(losses).all() and len(losses) == 4
