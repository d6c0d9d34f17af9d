"""The port's trainer with config.compile_cache (warm/), cold then warm,
on the CPU: a tiny FastSCNN reading a Custom PNG tree, so that the PNG
decoder loads the host library, which is then built (cold) or loaded
(warm) through the cache (K1 and K2 take their plain versions on the
CPU, and nothing calls nvcc). The cold run (through main_torch.main with
--compile_cache true) has compile events that are misses and the warm
run hits; losses and scores equal each other's and a run without the
cache (which builds into a _build/ under tmp_path); the report reads the
events. Each run starts the host library as a new process
would; the builders' state is restored afterwards."""

import json
import os

import numpy as np
import pytest
import torch

import main_torch
from torch_data_trees import custom_tree
from rtseg_tpu_torch import native
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.obs import report as treport
from rtseg_tpu_torch.train import SegTrainer
from rtseg_tpu_torch.warm import ExeCache, compile_cache, scan_cache


KW = dict(dataset='custom', num_class=3, model='fastscnn', crop_size=64,
          train_bs=2, val_bs=2, total_epoch=1, compute_dtype='float32',
          use_tb=False, use_obs=True, log_interval=0, load_ckpt=False,
          base_workers=2)


def _argv(kw):
    out = []
    for k, v in kw.items():
        out += [f'--{k}', str(v).lower() if isinstance(v, bool) else str(v)]
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The cold run through main_torch.main (--compile_cache true), the
    warm run through SegTrainer, and one without the cache; one torch
    thread each."""
    tmp = tmp_path_factory.mktemp('warm_trainer')
    tree = custom_tree(tmp / 'custom', n_train=4, n_val=2, hw=(48, 60))
    cache = str(tmp / 'cache')
    saved = (native._lib, native._tried, native._error, native._SO)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {'cache': cache, 'tmp': tmp}
    try:
        # the run without the cache builds into a _build/ of its own
        native._SO = tmp / '_build' / 'librtseg_host.so'
        for tag in ('cold', 'warm', 'plain'):
            native._lib, native._tried, native._error = None, False, None
            compile_cache.disable_compile_cache()
            kw = dict(KW, data_root=tree, save_dir=str(tmp / tag))
            if tag != 'plain':
                kw.update(compile_cache=True, compile_cache_dir=cache)
            if tag == 'cold':
                trainer, score = main_torch.main(['--device', 'cpu']
                                                 + _argv(kw))
            else:
                trainer = SegTrainer(SegConfig(**kw), device='cpu')
                score = trainer.run()
            events = treport.load_events(trainer.config.obs_dir)
            out[tag] = {'trainer': trainer, 'score': score,
                        'events': events,
                        'summary': treport.summarize(events)}
        yield out
    finally:
        torch.set_num_threads(threads)
        compile_cache.disable_compile_cache()
        native._lib, native._tried, native._error, native._SO = saved


def _compiles(run):
    return [e for e in run['events'] if e.get('event') == 'compile']


def test_cold_run_misses_and_warm_run_hits(runs):
    cold, warm = _compiles(runs['cold']), _compiles(runs['warm'])
    assert [e['name'] for e in cold] == ['rtseg_host']
    assert [e['cache_hit'] for e in cold] == [False]
    assert [e['name'] for e in warm] == ['rtseg_host']
    assert [e['cache_hit'] for e in warm] == [True]
    assert cold[0]['key'] == warm[0]['key'] and cold[0]['bytes'] > 0
    # the host library decoded the PNGs, loaded through the cache
    assert native.counts().get('png_unfilter', 0) > 0
    (entry,) = scan_cache(runs['cache'])['entries']
    assert entry['hits'] == 1 and entry['key'].startswith(cold[0]['key'])
    # one cache a process: the trainer's is the one the host library went
    # through; the steps launch no kernel on the CPU and acquire nothing,
    # no event for them
    for tag, hits, misses in (('cold', 0, 1), ('warm', 1, 0)):
        st = runs[tag]['trainer']._exe_cache.stats()
        assert (st['hits'], st['misses'], st['fallbacks']) == \
            (hits, misses, 0)
    t = runs['warm']['trainer']
    assert t.eval_step.kernels == () and t.train_step.kernels == ()
    assert t.train_step.exe_cache is t._exe_cache
    assert runs['plain']['trainer']._exe_cache is None


def test_losses_and_scores_are_those_without_the_cache(runs):
    losses = [r['trainer'].epoch_losses for r in
              (runs['cold'], runs['warm'], runs['plain'])]
    assert np.isfinite(losses[0]).all()
    assert losses[0] == losses[1] == losses[2]
    assert runs['cold']['score'] == runs['warm']['score'] == \
        runs['plain']['score']
    assert np.array_equal(runs['cold']['trainer'].last_cm,
                          runs['plain']['trainer'].last_cm)


def test_report_reads_the_startup_compiles(runs):
    cold, warm = runs['cold']['summary'], runs['warm']['summary']
    assert cold['startup_compiles'] == warm['startup_compiles'] == 1
    assert cold['startup_cache_hits'] == 0 and warm['startup_cache_hits'] == 1
    assert cold['startup_cold_s'] > 0 and warm['startup_cold_s'] == 0
    assert warm['startup_warm_s'] == warm['startup_compile_s']
    assert 'startup compile' in treport.format_summary(cold)
    assert 'startup compile (s)' in treport.diff_table(cold, warm)
    # the JAX report reads the port's events alike
    from rtseg_tpu.obs import report as jreport
    for tag in ('cold', 'warm'):
        want = jreport.summarize(runs[tag]['events'])
        got = runs[tag]['summary']
        for k in ('startup_compiles', 'startup_cache_hits', 'startup_cold_s',
                  'startup_warm_s', 'startup_compile_s'):
            assert got[k] == want[k], (tag, k)
    # the run without the cache builds in _build/: a cold event
    plain = runs['plain']['summary']
    assert plain['startup_compiles'] == 1 and plain['startup_cache_hits'] == 0


def test_main_torch_takes_compile_cache(runs):
    """The cold run came through main_torch.main: its config carries the
    switch, and its trainer has the cache."""
    cfg = runs['cold']['trainer'].config
    assert cfg.compile_cache is True and cfg.compile_cache_dir == \
        runs['cache']
    saved = json.load(open(os.path.join(cfg.save_dir, 'config.json')))
    assert saved['compile_cache'] is True
    assert isinstance(runs['cold']['trainer']._exe_cache, ExeCache)
