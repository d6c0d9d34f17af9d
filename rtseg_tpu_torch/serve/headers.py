"""The ``X-*`` wire-header names of the serving plane (counterpart of
rtseg_tpu/serve/headers.py, the same constants): the one module where
they are spelled. The streaming-session headers are kept with the others,
though the port's server does not mount the session plane yet.
"""

from __future__ import annotations

# ------------------------------------------------------------- tracing
#: request+response header carrying the 16-hex trace id, minted at
#: ingress (load-gen, router or replica) and echoed on every answer —
#: one id spans router -> replica -> response (obs/tracing.py owns the
#: id alphabet; the header spelling lives here with the other wires)
TRACE_HEADER = 'X-Trace-Id'

# ------------------------------------------------- per-image serving
#: response header attributing a response to the replica that served it
REPLICA_HEADER = 'X-Replica-Id'

#: request header carrying the caller's remaining latency budget in ms;
#: becomes the request's queue deadline (504 when it expires in queue)
DEADLINE_HEADER = 'X-Deadline-Ms'

#: response header naming the artifact version that produced the answer
#: (segship: a replica serving a registry bundle stamps the bundle's
#: content-hash version; the fleet router forwards it — or stamps the
#: routed arm's version — so load-gen and clients can attribute every
#: response to a model version during canary/shadow rollouts)
VERSION_HEADER = 'X-Artifact-Version'

#: response header on a drain-refused 503: tells the fleet router the
#: refusal is lifecycle (re-pick another replica), not backpressure
STATE_HEADER = 'X-Replica-State'

#: 503 X-Replica-State value while the replica drains
STATE_DRAINING = 'draining'

#: response header carrying the per-stage timing decomposition as JSON
#: (queue/assemble/device/post/decode ms + the trace id)
TIMING_HEADER = 'X-Serve-Timing'

#: raw-mask (?raw=1) response headers: 'h,w' shape and dtype of the
#: int8 argmax payload
MASK_SHAPE_HEADER = 'X-Mask-Shape'
MASK_DTYPE_HEADER = 'X-Mask-Dtype'

# ------------------------------------------------------ fleet routing
#: request header selecting the model group (the path segment wins)
MODEL_HEADER = 'X-Model'

# ------------------------------------------------- streaming sessions
#: request+response header carrying the session id (16 hex chars, same
#: alphabet/validation as trace ids — obs/tracing.valid_trace_id)
SESSION_HEADER = 'X-Session-Id'

#: request header: this frame's position in the session's stream
SEQ_HEADER = 'X-Frame-Seq'

#: response header: which path produced this mask
PROVENANCE_HEADER = 'X-Frame-Provenance'

#: response header: frames since the mask's source keyframe (0 = fresh)
MASK_AGE_HEADER = 'X-Mask-Age'

#: router->replica hint + router->client echo: the session was re-homed
#: (bound replica drained/died); the new replica forces a keyframe
MIGRATED_HEADER = 'X-Session-Migrated'
