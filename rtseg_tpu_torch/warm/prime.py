"""warm_step — acquire a built step's libraries through the ExeCache
(counterpart of rtseg_tpu/warm/prime.py).

The JAX wrapper lowers the step on its first call and obtains the
executable through the cache. A port step is eager PyTorch: what it
compiles are the CUDA kernel libraries it launches (train/step.py lists
them in ``step.kernels``: K1 and K2 for an eval step with the fused head
and the blocked matrix on the card, none for a train step). So the
wrapper's first call acquires each of them through the cache
(ops/cuda_build.py ``load``, one thread a library), then runs the step; every call runs the
step itself, so results are bit-equal to the unwrapped step. A step that
launches no kernel acquires nothing and emits no ``compile`` event.

The libraries are keyed without the step's pins (``step_pins``) and the
caller's ``extra``, where the JAX wrapper keys its program on both: a pin
decides which libraries a step launches (``defer_upsample`` decides K1),
not how a library is built, so a library prebuilt by
tools/torch_segwarm.py or loaded by another step is the same entry.
``step_pins`` and ``make_pins`` stay as the JAX package's API: the
engine checks the pins it is given with ``make_pins``, and a step's pins
name the configuration it was built for.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict

from .exe_cache import PIN_KEYS, ExeCache


def step_pins(step_fn: Any) -> Dict[str, Any]:
    """The pin values a built step carries (train/step.py) — the PIN_KEYS
    part of its libraries' keys."""
    return {k: getattr(step_fn, k, None) for k in PIN_KEYS}


def make_pins(**values: Any) -> Dict[str, Any]:
    """Pins for a cache key from explicit values, which must cover
    exactly PIN_KEYS: a call site that omits or invents one fails."""
    missing = [a for a in PIN_KEYS if a not in values]
    extra = [k for k in values if k not in PIN_KEYS]
    if missing or extra:
        raise ValueError(
            f'pins must cover exactly PIN_KEYS {PIN_KEYS}: missing '
            f'{missing}, unknown {extra}')
    return values


def warm_step(step_fn: Callable, cache: ExeCache, name: str,
              extra: Any = None) -> Callable:
    """Wrap a built step so that its first call acquires the libraries it
    launches through ``cache`` (events named ``<name>:<library>``). The
    wrapper carries the step's attributes, ``exe_cache`` and
    ``__wrapped__``; its ``_cache_size`` is the step's own (the count of
    input signatures seen: 0, then 1 after the first call). ``extra`` is
    the JAX signature's and keys nothing: a library's key is its build
    (module docstring)."""
    from ..ops import cuda_build
    kernels = tuple(getattr(step_fn, 'kernels', ()))
    done = [False]

    @functools.wraps(step_fn)
    def wrapper(*args, **kwargs):
        if not done[0]:
            # one thread a library: cold, the nvcc builds run side by side
            with ThreadPoolExecutor(max(1, len(kernels))) as pool:
                for fut in [pool.submit(cuda_build.load, lib, cache=cache,
                                        event=f'{name}:{lib}')
                            for lib in kernels]:
                    fut.result()
            done[0] = True
        return step_fn(*args, **kwargs)

    own = getattr(step_fn, '_cache_size', None)
    wrapper._cache_size = own if own is not None else (lambda: int(done[0]))
    wrapper.exe_cache = cache
    return wrapper
