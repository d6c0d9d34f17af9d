"""segwarm of the port — warm starts (counterpart of rtseg_tpu/warm).

What the port compiles at start-up are the shared libraries it builds
from its own sources: the CUDA kernels (nvcc, sm_90a) and the host
routines (cc). ``compile_cache.enable_compile_cache`` sends every build
of the process through an :class:`ExeCache` (``exe_cache``), which stores
each library under a content key and loads it on the next start instead
of rebuilding it; ``prime.warm_step`` acquires a step's libraries through
a given cache on its first call. Importable without a card: torch is
imported inside functions.
"""

from .compile_cache import enable_compile_cache
from .exe_cache import (PIN_KEYS, ExeCache, cache_key, clear_cache,
                        emit_compile_event, scan_cache, timed_compile)
from .prime import make_pins, step_pins, warm_step

__all__ = [
    'ExeCache', 'PIN_KEYS', 'cache_key', 'clear_cache', 'emit_compile_event',
    'enable_compile_cache', 'make_pins', 'scan_cache', 'step_pins',
    'timed_compile', 'warm_step',
]
