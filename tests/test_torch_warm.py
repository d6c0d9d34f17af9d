"""The port's warm starts (rtseg_tpu_torch/warm/) against the JAX
package's rtseg_tpu/warm where the functions compare: the cache key's
hex digest, the compile event, scan_cache. The rest on the CPU: a real
cc build of the host library through the cache, cold then warm in a
second ExeCache, the keys' axes, the fallback from a truncated entry, two
processes hitting one entry, the nvcc key with a stub compiler, pins,
warm_step, the engine's exe_cache/pins/compile_workers, and
tools/torch_segwarm.py warm/stats/clear with their exit codes.

Every cache lives under tmp_path; a test that turns the process's
compile cache on, or loads a library, restores the builders' state
(`builders` fixture), so other files in the worker load what they load
today."""

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rtseg_tpu import warm as jwarm
from rtseg_tpu.obs import core as jcore
from rtseg_tpu_torch import native
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.obs import core as tcore
from rtseg_tpu_torch.ops import cuda_build
from rtseg_tpu_torch.warm import (PIN_KEYS, ExeCache, cache_key,
                                  clear_cache, emit_compile_event,
                                  enable_compile_cache, make_pins,
                                  scan_cache, step_pins, warm_step)
from rtseg_tpu_torch.warm import compile_cache, exe_cache
from rtseg_tpu_torch.warm.exe_cache import LibraryBuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VERSIONS = {'torch': '2.11.0', 'cuda': '12.8', 'cc': 'cc (GCC) 12.2.0'}
BACKEND = {'platform': 'cuda', 'device_kinds': ['NVIDIA H100 80GB HBM3'],
           'capabilities': ['9.0'], 'n_devices': 1, 'world_size': 1,
           'env': {}}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the tier-1 run shares the cores between
    its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def builders():
    """The builders' process state, restored after the test: the compile
    cache off again, the host library and the kernel libraries as they
    were loaded before."""
    saved = (native._lib, native._tried, native._error,
             dict(cuda_build._libs))
    yield
    compile_cache.disable_compile_cache()
    native._lib, native._tried, native._error = saved[:3]
    cuda_build._libs.clear()
    cuda_build._libs.update(saved[3])


def _fresh_native():
    """The host library as a new process finds it: not tried yet."""
    native._lib, native._tried, native._error = None, False, None


def tiny_build(tmp_path, body='int add1(int x) { return x + 1; }',
               flags=('-O2',), name='tiny'):
    """A one-function C library: fast to build, same path as host.c's."""
    src = tmp_path / f'{name}.c'
    src.write_text(body)
    cmd = ('cc', *flags, '-shared', '-fPIC')

    def compile_(out):
        proc = subprocess.run([*cmd, '-o', out, str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(proc.stderr)
    return LibraryBuild(name=name, sources=((src.name, body),),
                        builder='tiny builder', command=cmd,
                        compile=compile_, device=False)


# -------------------------------------------------------------- key, events
@pytest.mark.parametrize('pins,extra', [
    (None, None),
    ({'bn_axis': None, 's2d_stem': False, 'defer_upsample': True}, None),
    ({'bn_axis': ('data',)}, 'ckpt-v2'),
])
def test_cache_key_is_the_jax_packages(pins, extra):
    text = 'program\x00text'
    for versions, backend in ((VERSIONS, BACKEND),
                              ({'jax': '0.4.37'}, {'platform': 'cpu'})):
        want = jwarm.cache_key(text, pins=pins, extra=extra,
                               versions=versions, backend=backend)
        got = cache_key(text, pins=pins, extra=extra, versions=versions,
                        backend=backend)
        assert got == want
    assert PIN_KEYS == jwarm.PIN_KEYS


def test_cache_key_axes_invalidate():
    base = dict(pins={'bn_axis': None, 's2d_stem': False},
                versions=VERSIONS, backend=BACKEND)
    k = cache_key('lib', **base)
    assert k == cache_key('lib', **base)
    assert k != cache_key('lib2', **base)
    assert k != cache_key('lib', **{**base, 'pins': {'bn_axis': ('data',),
                                                     's2d_stem': False}})
    assert k != cache_key('lib', **{**base, 'versions': {
        **VERSIONS, 'nvcc': 'Cuda compilation tools, release 12.9'}})
    assert k != cache_key('lib', **{**base, 'backend': {
        **BACKEND, 'capabilities': ['8.0']}})
    assert k != cache_key('lib', **{**base, 'backend': {
        **BACKEND, 'world_size': 2}})
    assert k != cache_key('lib', **{**base, 'backend': {
        **BACKEND, 'env': {'NVCC_APPEND_FLAGS': '-G'}}})
    assert k != cache_key('lib', **base, extra='x')


def test_compile_event_is_the_jax_packages(tmp_path):
    tsink = tcore.EventSink(str(tmp_path / 't.jsonl'), {'host': 0})
    jsink = jcore.EventSink(str(tmp_path / 'j.jsonl'), {'host': 0})
    tcore.set_sink(tsink)
    jcore.set_sink(jsink)
    try:
        for args, kw in ((('eval_step:fused_head', 1.23456789, False),
                          {'nbytes': 1024, 'key': 'ab' * 32}),
                         (('rtseg_host', 0.001, True), {}),
                         (('x', 2.0, True), {'key': 'c' * 64, 'bucket': 3})):
            emit_compile_event(*args, **kw)
            jwarm.emit_compile_event(*args, **kw)
    finally:
        tcore.set_sink(None)
        jcore.set_sink(None)
        tsink.close()
        jsink.close()

    def read(name):
        return [{k: v for k, v in json.loads(line).items() if k != 'ts'}
                for line in open(tmp_path / name)]
    assert read('t.jsonl') == read('j.jsonl') and len(read('t.jsonl')) == 3
    emit_compile_event('no sink', 1.0, False)      # no sink: nothing


def test_scan_and_clear_are_the_jax_packages(tmp_path):
    rng = np.random.default_rng(0)
    for root in (tmp_path / 'a', tmp_path / 'b'):
        exe = root / 'exe'
        exe.mkdir(parents=True)
        for i in range(3):
            key = f'{i:064x}'
            (exe / f'{key}.exe').write_bytes(rng.bytes(10 + i))
            (exe / f'{key}.json').write_text(json.dumps(
                {'key': key, 'name': f'lib{i}', 'bytes': 10 + i,
                 'hits': int(rng.integers(5))}))
        (exe / 'broken.json').write_text('{')
        (exe / 'fallbacks.jsonl').write_text(
            '{"key": "k", "name": "lib0", "error": "OSError: x"}\n\n{\n')
        (root / 'xla').mkdir()
        (root / 'xla' / 'f').write_bytes(b'12345')
    got, want = scan_cache(str(tmp_path / 'a')), \
        jwarm.scan_cache(str(tmp_path / 'a'))
    assert {**got, 'cache_dir': 0} == {**want, 'cache_dir': 0}
    assert got['n_entries'] == 3 and got['n_fallbacks'] == 1
    assert clear_cache(str(tmp_path / 'a')) == \
        jwarm.clear_cache(str(tmp_path / 'b')) == 3 + 3 + 1 + 1 + 1
    assert scan_cache(str(tmp_path / 'a'))['n_entries'] == 0


# --------------------------------------------------------- the host library
def test_host_library_through_the_cache_cold_then_warm(tmp_path, builders):
    build = native.library_build()
    assert build.name == 'rtseg_host' and not build.device
    assert [s[0] for s in build.sources] == ['host.c', 'jpeg.c']
    assert build.command[1:] == ('-O3', '-ffp-contract=off', '-shared',
                                 '-fPIC')
    cold = ExeCache(str(tmp_path / 'exe'))
    lib_cold, hit = cold.load_or_compile(build)
    assert not hit and cold.misses == 1 and cold.bytes_written > 0
    warm = ExeCache(str(tmp_path / 'exe'))
    lib_warm, hit = warm.load_or_compile(build)
    assert hit and warm.hits == 1 and warm.fallbacks == 0
    assert warm.bytes_read == cold.bytes_written
    (entry,) = scan_cache(str(tmp_path))['entries']
    blob = (tmp_path / 'exe' / f'{entry["key"]}.exe').read_bytes()
    assert len(blob) == entry['bytes'] and entry['hits'] == 1
    assert entry['cc'] == exe_cache.compiler_version('cc')
    # normalize_u8_hwc through either load, bit for bit
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (17, 23, 3), np.uint8)
    scale = rng.uniform(0.5, 2, 3).astype(np.float32)
    bias = rng.uniform(-1, 1, 3).astype(np.float32)
    outs = []
    for lib in (native._declare(lib_cold), native._declare(lib_warm)):
        for flip in (0, 1):
            out = np.empty(img.shape, np.float32)
            lib.normalize_u8_hwc(native._ptr(img, ctypes.c_uint8),
                                 native._ptr(out, ctypes.c_float), 17, 23, 3,
                                 native._ptr(scale, ctypes.c_float),
                                 native._ptr(bias, ctypes.c_float), flip)
            outs.append(out)
    assert outs[0].tobytes() == outs[2].tobytes()
    assert outs[1].tobytes() == outs[3].tobytes()
    assert not np.array_equal(outs[0], outs[1])
    # the key's axes for this build: pins, flags, source text, compiler
    key = warm.key_of(build)
    assert key == entry['key']
    assert warm.key_of(build, pins=make_pins(
        bn_axis=None, s2d_stem=False, defer_upsample=True)) != key
    for changed in (
            LibraryBuild(**{**build.__dict__,
                            'command': build.command + ('-g',)}),
            LibraryBuild(**{**build.__dict__, 'sources': (
                (build.sources[0][0], build.sources[0][1] + '\n'),
                build.sources[1])})):
        assert warm.key_of(changed) != key


def test_each_changed_axis_misses(tmp_path, monkeypatch):
    cache = ExeCache(str(tmp_path / 'exe'))
    build = tiny_build(tmp_path)
    lib, hit = cache.load_or_compile(build)
    assert not hit and lib.add1(41) == 42
    assert cache.load_or_compile(build)[1]
    pins = dict(bn_axis=None, s2d_stem=False, defer_upsample=False)
    assert not cache.load_or_compile(build, pins=pins)[1]
    assert not cache.load_or_compile(
        build, pins={**pins, 'defer_upsample': True})[1]
    assert not cache.load_or_compile(tiny_build(tmp_path,
                                                flags=('-O1',)))[1]
    other = tiny_build(tmp_path, body='int add1(int x) { return x + 2; }')
    lib, hit = cache.load_or_compile(other)
    assert not hit and lib.add1(41) == 43
    monkeypatch.setattr(exe_cache, 'compiler_version',
                        lambda c: 'cc (GCC) 99.0')
    assert not cache.load_or_compile(build)[1]
    assert cache.stats()['misses'] == 6 and cache.stats()['hits'] == 1
    assert scan_cache(str(tmp_path))['n_entries'] == 6


def test_truncated_entry_falls_back_to_a_fresh_build(tmp_path):
    build = tiny_build(tmp_path)
    ExeCache(str(tmp_path / 'exe')).load_or_compile(build)
    (entry,) = scan_cache(str(tmp_path))['entries']
    path = tmp_path / 'exe' / f'{entry["key"]}.exe'
    with open(path, 'r+b') as f:
        f.truncate(entry['bytes'] // 2)
    cache = ExeCache(str(tmp_path / 'exe'))
    with pytest.warns(UserWarning, match='falling back to a fresh build'):
        lib, hit = cache.load_or_compile(build)
    assert not hit and lib.add1(1) == 2
    assert cache.fallbacks == 1 and cache.misses == 1
    s = scan_cache(str(tmp_path))
    assert s['n_fallbacks'] == 1 and 'ValueError' in \
        s['fallbacks'][0]['error']
    # the rebuilt entry is whole again: the next acquisition hits
    assert ExeCache(str(tmp_path / 'exe')).load_or_compile(build)[1]
    # a file that is no library fails dlopen: also a recorded fallback
    path.write_bytes(b'not a library')
    meta = json.loads((tmp_path / 'exe' / f'{entry["key"]}.json')
                      .read_text())
    import hashlib
    meta['sha256'] = hashlib.sha256(b'not a library').hexdigest()
    (tmp_path / 'exe' / f'{entry["key"]}.json').write_text(json.dumps(meta))
    with pytest.warns(UserWarning, match='OSError'):
        assert not ExeCache(str(tmp_path / 'exe')).load_or_compile(
            build)[1]
    assert scan_cache(str(tmp_path))['n_fallbacks'] == 2


def test_a_read_only_cache_still_hits(tmp_path, monkeypatch):
    """A cache directory that cannot be written (baked into an image, a
    read-only mount) serves hits: a hit loads its checked bytes from the
    temporary directory and writes nothing under the cache."""
    build = tiny_build(tmp_path)
    root = tmp_path / 'exe'
    ExeCache(str(root)).load_or_compile(build)
    assert ExeCache(str(root)).load_or_compile(build)[1]
    before = sorted(os.listdir(root))
    loaded, real = [], ctypes.CDLL

    def spy(path, *a, **kw):
        loaded.append(os.path.dirname(os.path.abspath(path)))
        return real(path, *a, **kw)
    monkeypatch.setattr(ctypes, 'CDLL', spy)
    os.chmod(root, 0o555)
    try:
        cache = ExeCache(str(root))
        lib, hit = cache.load_or_compile(build)
    finally:
        os.chmod(root, 0o755)
    assert hit and lib.add1(2) == 3
    assert (cache.hits, cache.misses, cache.fallbacks) == (1, 0, 0)
    assert loaded and str(root) not in loaded
    assert sorted(os.listdir(root)) == before
    assert scan_cache(str(tmp_path))['n_fallbacks'] == 0


def test_store_gates(tmp_path):
    build = tiny_build(tmp_path)
    cache = ExeCache(str(tmp_path / 'exe'), min_entry_bytes=1 << 30)
    assert not cache.load_or_compile(build)[1]
    assert cache.load_or_compile(build)[0].add1(0) == 1
    assert scan_cache(str(tmp_path))['n_entries'] == 0
    cache = ExeCache(str(tmp_path / 'exe'), min_compile_secs=1e6)
    cache.load_or_compile(build)
    assert scan_cache(str(tmp_path))['n_entries'] == 0


_TWO = textwrap.dedent('''
    import subprocess, sys
    sys.path.insert(0, {root!r})
    from rtseg_tpu_torch.warm.exe_cache import ExeCache, LibraryBuild
    src = {src!r}
    def compile_(out):
        subprocess.run(['cc', '-O2', '-shared', '-fPIC', '-o', out, src],
                       check=True)
    build = LibraryBuild(name='tiny', sources=(('tiny.c', {body!r}),),
                         builder='tiny builder',
                         command=('cc', '-O2', '-shared', '-fPIC'),
                         compile=compile_, device=False)
    sys.stdin.readline()
    lib, hit = ExeCache({exe!r}).load_or_compile(build)
    print(hit, lib.add1(1))
''')


def test_two_processes_share_an_entry(tmp_path):
    build = tiny_build(tmp_path)
    ExeCache(str(tmp_path / 'exe')).load_or_compile(build)
    code = _TWO.format(root=ROOT, src=str(tmp_path / 'tiny.c'),
                       body=build.sources[0][1], exe=str(tmp_path / 'exe'))
    procs = [subprocess.Popen([sys.executable, '-c', code],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for p in procs:                      # both released at once
        p.stdin.write('go\n')
        p.stdin.flush()
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert outs == [['True', '2'], ['True', '2']]
    (entry,) = scan_cache(str(tmp_path))['entries']
    assert entry['hits'] == 2 and 'last_used' in entry


def test_nvcc_key_with_a_stub_compiler(tmp_path, monkeypatch):
    stub = tmp_path / 'bin' / 'nvcc'
    stub.parent.mkdir()
    stub.write_text('#!/bin/sh\n'
                    'if [ "$1" = --version ]; then echo "stub nvcc 1.0"; '
                    'exit 0; fi\n'
                    f'echo "$@" > {tmp_path}/argv\n'
                    'while [ "$1" != -o ]; do shift; done\n'
                    'echo so > "$2"\n')
    stub.chmod(0o755)
    monkeypatch.setenv('PATH', f'{stub.parent}:{os.environ["PATH"]}')
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)
    build = cuda_build.library_build('fused_head')
    assert build.command == (str(stub), *cuda_build.NVCC_FLAGS)
    assert build.device and build.sources[0][0] == 'fused_head.cu'
    assert 'head_argmax_kernel' in build.sources[0][1]
    assert build.builder.startswith('"""Builds the port')
    build.compile(str(tmp_path / 'out.so'))
    assert (tmp_path / 'out.so').read_text() == 'so\n'
    argv = (tmp_path / 'argv').read_text().split()
    assert argv[:len(cuda_build.NVCC_FLAGS)] == cuda_build.NVCC_FLAGS
    assert argv[-1].endswith('csrc/fused_head.cu')
    cache = ExeCache(str(tmp_path / 'exe'))
    key = cache.key_of(build)
    assert exe_cache._versions(build.command[:1])['nvcc'] == 'stub nvcc 1.0'
    want = cache_key(build.program_text(),
                     versions={'torch': torch.__version__,
                               'cuda': str(torch.version.cuda),
                               'nvcc': 'stub nvcc 1.0'},
                     backend=exe_cache.backend_fingerprint(True))
    assert key == want
    assert cache.key_of(cuda_build.library_build('confusion_matrix')) != key
    monkeypatch.setenv('NVCC_APPEND_FLAGS', '-lineinfo')
    assert cache.key_of(build) != key
    # the stub writes no library: loading it raises, and nothing is stored
    with pytest.raises(OSError):
        cache.load_or_compile(build)
    assert scan_cache(str(tmp_path))['n_entries'] == 0


def test_failed_builds_raise_or_leave_the_host_library_unavailable(
        tmp_path, builders, monkeypatch):
    build = tiny_build(tmp_path, body='int add1(int x) { return x + }')
    with pytest.raises(RuntimeError, match='error'):
        ExeCache(str(tmp_path / 'exe')).load_or_compile(build)
    enable_compile_cache(cache_dir=str(tmp_path / 'c'))
    monkeypatch.setenv('CC', str(tmp_path / 'no_such_cc'))
    _fresh_native()
    assert not native.available()
    assert 'FileNotFoundError' in native.build_error()


# ------------------------------------------------------ the process's cache
def test_enable_compile_cache_is_idempotent_and_routes_the_builders(
        tmp_path, builders):
    assert compile_cache.active_cache() is None
    cfg = SegConfig(compile_cache=True, save_dir=str(tmp_path / 'save'),
                    compile_cache_min_entry_bytes=5)
    cfg.resolve(num_devices=1)
    root = enable_compile_cache(cfg)
    assert root == str(tmp_path / 'save' / 'segwarm' / 'exe')
    cache = compile_cache.active_cache()
    assert enable_compile_cache(cfg) == root
    assert compile_cache.active_cache() is cache      # idempotent
    assert cache.min_entry_bytes == 5
    assert compile_cache.settings() == {
        'cache_dir': str(tmp_path / 'save' / 'segwarm'),
        'min_entry_bytes': 5, 'min_compile_secs': 0.0}
    with pytest.raises(ValueError, match='cache_dir'):
        enable_compile_cache()
    _fresh_native()
    assert native.available()
    assert cache.misses == 1
    (entry,) = scan_cache(root[:-len('/exe')])['entries']
    assert entry['name'] == 'rtseg_host'
    # a library already loaded stays loaded: not acquired again
    assert native.available() and cache.misses + cache.hits == 1


# ----------------------------------------------------------- pins and steps
def test_make_pins_refuses_missing_or_unknown():
    assert make_pins(bn_axis=None, s2d_stem=False, defer_upsample=True) == \
        {'bn_axis': None, 's2d_stem': False, 'defer_upsample': True}
    with pytest.raises(ValueError, match=r"missing \['defer_upsample'\]"):
        make_pins(bn_axis=None, s2d_stem=False)
    with pytest.raises(ValueError, match=r"unknown \['remat'\]"):
        make_pins(bn_axis=None, s2d_stem=False, defer_upsample=False,
                  remat=True)


def test_warm_step_is_bit_equal_and_acquires_its_kernels(tmp_path,
                                                         monkeypatch):
    from rtseg_tpu_torch.models.registry import get_model
    from rtseg_tpu_torch.train.step import build_eval_step, build_train_step
    from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                               load_jax_variables)
    cfg = SegConfig(model='fastscnn', num_class=5, compute_dtype='float32',
                    sync_bn=True, save_dir=str(tmp_path))
    cfg.resolve(num_devices=1)
    model = get_model(cfg, device='cpu').eval()
    load_jax_variables(model, flax_init_variables(model, 0))
    step = build_eval_step(cfg, model, 'cpu')
    assert step_pins(step) == {'bn_axis': None, 's2d_stem': False,
                               'defer_upsample': False}
    assert step.kernels == ()                  # the CPU launches none
    cfg.resolve_schedule(train_num=2)
    assert step_pins(build_train_step(cfg))['bn_axis'] == ('data',)
    cache = ExeCache(str(tmp_path / 'exe'))
    wrapped = warm_step(step, cache, 'eval_step')
    assert wrapped.__wrapped__ is step and wrapped.exe_cache is cache
    assert wrapped.fused is step.fused and wrapped.kernels == ()
    assert wrapped._cache_size() == 0
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.standard_normal((2, 32, 32, 3),
                                                np.float32))
    msks = torch.from_numpy(rng.integers(0, 5, (2, 32, 32)))
    got = wrapped(imgs, msks)
    assert wrapped._cache_size() == 1
    assert torch.equal(got, step(imgs, msks))
    assert cache.stats()['misses'] + cache.stats()['hits'] == 0
    # a step that launches kernels acquires each once, on its first call,
    # through the given cache
    calls = []
    monkeypatch.setattr(cuda_build, 'load',
                        lambda name, **kw: calls.append((name, kw)))

    def fake(x):
        return x + 1
    fake.kernels = ('fused_head', 'confusion_matrix')
    fake.defer_upsample = True
    w = warm_step(fake, cache, 'eval_step', extra='e')
    assert w(1) == 2 and w(2) == 3
    assert sorted(calls, key=lambda c: c[0]) == [
        (n, {'cache': cache, 'event': f'eval_step:{n}'})
        for n in ('confusion_matrix', 'fused_head')]
    assert w._cache_size() == 1


def test_kernel_libraries_go_through_the_process_cache(tmp_path, builders,
                                                       monkeypatch):
    """cuda_build.load/build with the cache on: one acquisition a library
    (threads for build), each through the cache; without it, _build/."""
    acquired = []

    class Cache:
        def load_or_compile(self, build, name=None, pins=None, extra=None):
            acquired.append((build.name, name))
            return f'lib:{build.name}', True
    monkeypatch.setattr(cuda_build, 'library_build',
                        lambda name: LibraryBuild(name, (), '', ('nvcc',),
                                                  None))
    monkeypatch.setattr(compile_cache, '_active', Cache())
    cuda_build._libs.clear()
    assert cuda_build.build() == {}
    assert sorted(acquired) == [('confusion_matrix', 'confusion_matrix'),
                                ('fused_head', 'fused_head')]
    assert cuda_build.load('fused_head') == 'lib:fused_head'
    assert len(acquired) == 2                        # loaded: not again
    cuda_build._libs.clear()
    assert cuda_build.load('fused_head', event='eval_step:fused_head') \
        == 'lib:fused_head'
    assert acquired[-1] == ('fused_head', 'eval_step:fused_head')


# -------------------------------------------------------------- the engine
def test_engine_exe_cache_pins_and_compile_workers(tmp_path, builders,
                                                   monkeypatch):
    """from_config with compile_cache turns the process's cache on and
    checks the JAX engine's pins; its masks are those without the cache
    and it acquires nothing (its graphs launch no library)."""
    import rtseg_tpu_torch.warm as twarm
    from rtseg_tpu_torch.serve import ServeEngine
    kw = dict(model='fastscnn', num_class=3, compute_dtype='float32',
              save_dir=str(tmp_path))
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    plain = SegConfig(**kw)
    plain.resolve(num_devices=1)
    ref = ServeEngine.from_config(plain, [(32, 32)], 2, device='cpu')
    assert compile_cache.active_cache() is None
    pins = []
    monkeypatch.setattr(twarm, 'make_pins',
                        lambda **v: pins.append(v) or make_pins(**v))
    cfg = SegConfig(compile_cache=True, **kw)
    cfg.resolve(num_devices=1)
    engine = ServeEngine.from_config(cfg, [(32, 32)], 2, device='cpu')
    cache = compile_cache.active_cache()
    assert cache.root == str(tmp_path / 'segwarm' / 'exe')
    assert pins[0] == {'bn_axis': None, 's2d_stem': False,
                       'defer_upsample': False}
    st = engine.stats()
    assert st['cache_hits'] == 0 and st['executables'] == 1
    assert np.array_equal(engine.run((32, 32), x), ref.run((32, 32), x))
    assert cache.stats()['hits'] + cache.stats()['misses'] == 0
    with pytest.raises(ValueError, match='missing'):
        ServeEngine(lambda x: x, [(32, 32)], 2, device='cpu',
                    pins={'bn_axis': None})
    workers = SegConfig(compile_workers=2, **kw)
    workers.resolve(num_devices=1)
    with pytest.raises(NotImplementedError, match='"The planes"'):
        ServeEngine.from_config(workers, [(32, 32)], 2, device='cpu')


# --------------------------------------------------------------- the tool
def _tool():
    spec = importlib.util.spec_from_file_location(
        'torch_segwarm', os.path.join(ROOT, 'tools', 'torch_segwarm.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_segwarm_warm_stats_clear(tmp_path, builders, capsys):
    tool = _tool()
    d = str(tmp_path / 'cache')
    _fresh_native()
    assert tool.main(['warm', '--cache-dir', d, '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert '1 built + stored' in out and '0 fallback(s)' in out
    assert tool.main(['stats', '--cache-dir', d, '--check']) == 0
    assert 'check OK: 1 entries' in capsys.readouterr().out
    assert tool.main(['stats', '--cache-dir', d, '--json']) == 0
    s = json.loads(capsys.readouterr().out)
    assert s['n_entries'] == 1 and s['entries'][0]['name'] == 'rtseg_host'
    assert tool.main(['stats', '--cache-dir', d, '--check',
                      '--min-hits', '1']) == 1
    # a second process would hit
    _fresh_native()
    assert tool.main(['warm', '--cache-dir', d, '--device', 'cpu']) == 0
    assert '1 already cached' in capsys.readouterr().out
    # a truncated entry: a warning, a recorded fallback, a rebuild
    exe = os.path.join(d, 'exe', s['entries'][0]['key'] + '.exe')
    with open(exe, 'r+b') as f:
        f.truncate(100)
    _fresh_native()
    with pytest.warns(UserWarning, match='falling back'):
        assert tool.main(['warm', '--cache-dir', d, '--device', 'cpu']) == 0
    assert '1 fallback(s)' in capsys.readouterr().out
    # a config's first train and eval step under the cache (the CPU's
    # steps launch no kernel: the host library alone, now whole again)
    _fresh_native()
    assert tool.main(['warm', '--cache-dir', d, '--device', 'cpu',
                      '--train', '--models', 'fastscnn', '--num_class', '3',
                      '--compute_dtype', 'float32', '--train-bs', '2',
                      '--crop', '32']) == 0
    out = capsys.readouterr().out
    assert 'fastscnn: train+eval steps (bs2, 32x32)' in out
    assert '0 built + stored' in out and '1 already cached' in out
    assert tool.main(['stats', '--cache-dir', d, '--check']) == 1
    assert 'check FAILED' in capsys.readouterr().err
    assert tool.main(['clear', '--cache-dir', d]) == 0
    assert 'removed' in capsys.readouterr().out
    assert tool.main(['stats', '--cache-dir', d, '--check']) == 0
    # usage errors
    assert tool.main(['warm', '--cache-dir', d, '--train']) == 2
    with pytest.raises(SystemExit) as e:
        tool.main(['stats'])
    assert e.value.code == 2
