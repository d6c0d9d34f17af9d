"""Request trace ids (counterpart of rtseg_tpu/obs/tracing.py, the same
code: pure stdlib).

A trace id is minted once per request, at HTTP ingress (serve/server.py,
which honours a well-formed inbound ``X-Trace-Id``) or at load-generator
submit (serve/loadgen.py), and rides the request's ``meta`` dict through
the batcher's ``ingress`` and ``batch`` events, dispatch, readback and
postprocess (the ``request`` event) to the ``X-Trace-Id`` and
``X-Serve-Timing`` response headers.

Ids are 16 lowercase hex chars: an 8-hex per-process random prefix and an
8-hex sequence number from ``itertools.count`` (whose ``next`` is atomic
in CPython, so minting is thread-safe).
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, Optional

#: meta / event / header-JSON key a trace id travels under. The HTTP
#: header spelling (X-Trace-Id) lives with the other wire headers in
#: serve/headers.py; obs stays import-light (no serve dependency).
TRACE_KEY = 'trace_id'

_PREFIX = os.urandom(4).hex()
_SEQ = itertools.count(1)

_HEX = set('0123456789abcdef')


def new_trace_id() -> str:
    """Mint a fresh 16-hex trace id (process prefix + atomic sequence)."""
    return f'{_PREFIX}{next(_SEQ) & 0xffffffff:08x}'


def valid_trace_id(tid: Any) -> bool:
    """Accept only well-formed ids from the wire (16-64 hex chars), so a
    hostile or buggy client can't inject arbitrary strings into events."""
    return (isinstance(tid, str) and 16 <= len(tid) <= 64
            and set(tid) <= _HEX)


def ensure_trace(meta: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Return ``meta`` (or a new dict) guaranteed to carry a trace id.
    An existing well-formed id is preserved — minting happens once, at
    the first ingress point that sees the request."""
    m = meta if meta is not None else {}
    if not valid_trace_id(m.get(TRACE_KEY)):
        m[TRACE_KEY] = new_trace_id()
    return m
