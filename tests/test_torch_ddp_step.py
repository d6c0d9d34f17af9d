"""The port's data-parallel train step against the JAX package's
`('data',)` mesh of 2 devices, on the CPU.

BiSeNetv2 with its aux heads and OHEM at 64x128 under SGD OneCycle with
EMA (peak LR 1e-3), 3 steps of a global batch of 4 distinct synthetic
samples: 2 gloo ranks of 2 samples each (spawned processes,
tests/_torch_ddp_worker.py) against the JAX build_train_step on
Mesh(jax.devices()[:2], ('data',)) at the global batch 4, with sync_bn on
and off: the mean of the ranks' losses against the JAX step's pmean'd
loss, each rank's weights, BatchNorm running statistics and EMA against
the JAX state, within the limits of tests/test_torch_train_step.py
(1e-4). Without sync_bn a rank's BatchNorm normalizes its own 2 samples,
and the context block's over pooled features (2 values a channel)
cancels in E[x^2] - E[x]^2: there the JAX package's own float32 run lies
1.05e-3 from its float64 run (and at 4 samples a rank the port's float32
run still 1.2e-4 from JAX's). So that case is held as the training
forwards are: the port's float64 run against the JAX float64 run, each
leaf within 1e-4 or no farther than the port's float32 run lies from it
(tests/test_torch_backbone.py `assert_near_float64`). The ranks' synced
training forward is held to Flax's under shard_map run in float64 the
same way. The 2-rank sync_bn run equals one process at the
batch of 4 within 1e-6 with the forward in float64 (the order of the sums
is the only difference), and a gloo group of one rank gives the bits of
no group. The ranks run while the JAX steps compile.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch

import _torch_ddp_worker as ddp
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train.step import dropout_seed
from rtseg_tpu_torch.utils.convert import random_jax_variables
from test_torch_backbone import _err, assert_near_float64

WORLD = 2
KW = ddp.STEP_KW


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


def _worst(got, want):
    """(the smallest tol at which np.allclose(got, want, atol=tol,
    rtol=tol) holds, its leaf) over two variable trees."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    return max((float((np.abs(got[k] - want[k])
                       / (1.0 + np.abs(want[k]))).max()), k) for k in got)


def _jax_config(**kw):
    import dataclasses
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    names = {f.name for f in dataclasses.fields(JaxSegConfig)}
    jcfg = JaxSegConfig(**{k: v for k, v in {**KW, **kw}.items()
                           if k in names})
    jcfg.resolve(num_devices=WORLD)
    jcfg.resolve_schedule(train_num=KW['synthetic_len'])
    return jcfg


def _jax_steps(variables, batches, mesh, sync: bool):
    """(the JAX step on `mesh` lowered, run(compiled) -> (per-step
    losses, final state)), the weights and images in float32 with
    sync_bn and in float64 without. The step is traced here, with its
    BatchNorm axis pinned, so that the programs can compile side by
    side."""
    from rtseg_tpu.models import get_model as jax_get_model
    from rtseg_tpu.train.optim import get_optimizer
    from rtseg_tpu.train.state import TrainState
    from rtseg_tpu.train.step import build_train_step
    x64 = not sync
    if x64:
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 variables)
        batches = [(i.astype(np.float64), m) for i, m in batches]
    with jax.enable_x64(x64):
        jcfg = _jax_config(sync_bn=sync)
        model, opt = jax_get_model(jcfg), get_optimizer(jcfg)
        step = build_train_step(jcfg, model, opt, mesh)
        params = jax.tree.map(jnp.asarray, variables['params'])
        stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
        # the JAX EMA is float32 in any mode (train/state.py ema_update)
        ema = jax.tree.map(lambda a: jnp.array(a, jnp.float32),
                           (params, stats))
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=opt.init(params),
                           ema_params=ema[0], ema_batch_stats=ema[1])
        # placed as the step takes and returns them
        state = jax.device_put(state, NamedSharding(mesh, P()))
        split = NamedSharding(mesh, P('data'))
        batches = [jax.device_put(b, split) for b in batches]
        step.pin()
        lowered = step.jitted.lower(state, *batches[0])

    def run(compiled):
        st, losses = state, []
        with jax.enable_x64(x64):
            for imgs, msks in batches:
                st, metrics = compiled(st, imgs, msks)
                losses.append(float(metrics['loss']))
            return losses, jax.device_get(
                {'step': st.step,
                 'variables': {'params': st.params,
                               'batch_stats': st.batch_stats},
                 'ema': {'params': st.ema_params,
                         'batch_stats': st.ema_batch_stats}})
    return lowered, run


def _flax_forward(variables, x, mesh, dtype):
    """(Flax's training forward of the global batch under shard_map,
    BatchNorm statistics averaged over the 'data' axis, lowered on the
    variables and input in `dtype`, run(compiled) -> (outputs,
    batch_stats))."""
    from rtseg_tpu.models.bisenetv2 import BiSeNetv2 as FlaxBiSeNetv2
    from rtseg_tpu.nn import set_bn_axis
    from rtseg_tpu.train.step import _shard_map
    fmodel = FlaxBiSeNetv2(num_class=KW['num_class'], use_aux=True)

    def fwd(v, x):
        out, mut = fmodel.apply(v, x, True, mutable=['batch_stats'])
        return out, mut['batch_stats']
    x64 = dtype == jnp.float64
    set_bn_axis(('data',))
    try:
        with jax.enable_x64(x64):
            args = jax.device_put(
                (jax.tree.map(lambda a: np.asarray(a, dtype), variables),
                 np.asarray(x, dtype)),
                (NamedSharding(mesh, P()), NamedSharding(mesh, P('data'))))
            sm = _shard_map(fwd, mesh, in_specs=(P(), P('data')),
                            out_specs=(P('data'), P()))
            lowered = jax.jit(sm).lower(*args)
    finally:
        set_bn_axis(None)

    def run(compiled):
        with jax.enable_x64(x64):
            o = compiled(*args)
            assert jax.tree.leaves(o)[0].dtype == dtype
            return jax.device_get(o)
    return lowered, run


def _compiled_run(program):
    lowered, run = program
    return run(lowered.compile())


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The ranks' results (started first, so they run while the JAX steps
    compile) and the JAX package's."""
    from rtseg_tpu.config import SegConfig as JaxSegConfig
    from rtseg_tpu.data.synthetic import Synthetic as JaxSynthetic
    tmp = tmp_path_factory.mktemp('ddp_step')
    variables = random_jax_variables(get_model(SegConfig(**KW)), seed=0)
    ds = JaxSynthetic(JaxSegConfig(**{k: KW[k] for k in (
        'crop_h', 'crop_w', 'num_class')}), mode='train', length=12)
    bs = KW['train_bs'] * WORLD
    batches = [tuple(np.stack(a) for a in zip(*(ds.get(k * bs + i)
                                                 for i in range(bs))))
               for k in range(3)]
    x = np.random.RandomState(42).uniform(
        -1.5, 1.5, (4, KW['crop_h'], KW['crop_w'], 3)).astype(np.float32)
    ranks = ddp.start('ddp_steps', WORLD, tmp, variables=variables,
                      batches=batches, forward_x=x)
    alone = ddp.start('one_rank_group', 1, tmp, variables=variables,
                      batches=batches)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    programs = {sync: _jax_steps(variables, batches, mesh, sync)
                for sync in (True, False)}
    programs['flax'] = _flax_forward(variables, x, mesh, jnp.float64)
    # XLA compiles the three programs side by side (it frees the GIL)
    with ThreadPoolExecutor(len(programs)) as pool:
        compiled = dict(zip(programs, pool.map(lambda p: p[0].compile(),
                                               programs.values())))
    out = {'jax': {sync: programs[sync][1](compiled[sync])
                   for sync in (True, False)},
           'flax64': programs['flax'][1](compiled['flax']),
           # Flax's float32 forward, compiled only where a value lies
           # farther than 1e-4 from the float64 one (assert_near_float64)
           'flax32': functools.lru_cache(lambda: _compiled_run(
               _flax_forward(variables, x, mesh, jnp.float32)))}
    out['ranks'] = ranks.results()
    out['alone'] = alone.results()[0]
    return out


@pytest.mark.parametrize('sync', [True, False])
def test_three_steps_match_the_jax_mesh(runs, sync):
    """Per-step losses (the ranks' mean) within 1e-4 relative; every
    rank's params, batch_stats, EMA params and EMA batch_stats within
    1e-4 of the JAX state; the ranks' weights equal."""
    losses, state = runs['jax'][sync]
    dtype = torch.float32 if sync else torch.float64
    ranks = [r[sync, dtype] for r in runs['ranks']]
    mean = np.mean([r['losses'] for r in ranks], axis=0)
    np.testing.assert_allclose(mean, losses, rtol=1e-4)
    for rank, r in enumerate(runs['ranks']):
        got = r[sync, dtype]
        assert got['step'] == int(state['step']) == 3
        for what in ('variables', 'ema'):
            if sync:
                worst = _worst(got[what], state[what])
                assert worst[0] <= 1e-4, (what, worst)
                continue
            own = dict(_leaves(r[sync, torch.float32][what]))
            want = dict(_leaves(state[what]))
            assert own.keys() == want.keys()
            for k, v in _leaves(got[what]):
                assert_near_float64(v, want[k], own[k], f'rank {rank} {k}')
    for a, b in zip(_leaves(ranks[0]['variables']),
                    _leaves(ranks[1]['variables'])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])
    # per-rank statistics part the runs: without sync_bn the ranks'
    # losses differ from the synced ones
    if not sync:
        synced = [r[True, dtype]['losses'] for r in runs['ranks']]
        assert np.mean(synced, axis=0)[0] != mean[0]


def test_synced_training_forward_matches_flax_float64(runs):
    """Each rank's logits, its 4 aux logits and the synced batch_stats of
    one training forward against Flax's run of the global batch on the
    2-device mesh in float64 (assert_near_float64's limits)."""
    o64, bs64 = runs['flax64']
    b = o64[0].shape[0] // WORLD

    def near(got, want64, want32, what):
        if _err(got, want64) > 1e-4:
            assert_near_float64(got, want64, want32(), what)

    def o32(*path):
        def get():
            o = runs['flax32']()[0]
            for i in path:
                o = o[i]
            return o[part]
        return get
    for rank, r in enumerate(runs['ranks']):
        got = r['forward']
        part = slice(rank * b, (rank + 1) * b)
        near(got['logits'], o64[0][part], o32(0), f'rank {rank} logits')
        assert len(got['aux']) == 4
        for i, a in enumerate(got['aux']):
            near(a, o64[1][i][part], o32(1, i), f'rank {rank} aux {i}')
        g, w64 = (dict(_leaves(t)) for t in (got['batch_stats'], bs64))
        assert g.keys() == w64.keys()
        for k in g:
            near(g[k], w64[k],
                 lambda k=k: dict(_leaves(runs['flax32']()[1]))[k],
                 f'rank {rank} {k}')


def test_two_ranks_equal_one_process_at_the_global_batch_float64(runs):
    """sync_bn over 2 ranks of 2 against one process of 4, the forward in
    float64: losses, weights and EMA within 1e-6."""
    one = runs['ranks'][0]['one_process64']
    twice = [r[True, torch.float64] for r in runs['ranks']]
    mean = np.mean([r['losses'] for r in twice], axis=0)
    np.testing.assert_allclose(mean, one['losses'], rtol=1e-6, atol=0)
    for got in twice:
        for what in ('variables', 'ema'):
            worst = _worst(got[what], one[what])
            assert worst[0] <= 1e-6, (what, worst)


@pytest.mark.parametrize('remat', [False, True])
def test_a_group_of_one_rank_gives_the_bits_of_no_group(runs, remat):
    res = runs['alone'][remat]
    assert res['losses'][0] == res['losses'][1]
    assert res['differ'] == []


def test_rank_zero_draws_the_dropout_masks_of_one_process():
    for seed, step in ((0, 0), (3, 7), (2 ** 31 - 1, 2 ** 32 - 1)):
        one_process = (((seed + 1) << 32) + step) % (1 << 64)
        assert dropout_seed(seed, step) == one_process
        assert dropout_seed(seed, step, 0) == one_process
        seeds = {dropout_seed(seed, step, r) for r in range(8)}
        assert len(seeds) == 8 and all(0 <= s < 2 ** 64 for s in seeds)
