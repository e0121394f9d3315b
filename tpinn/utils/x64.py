"""Serialized access to the process-global ``jax_enable_x64`` flag.

``jax.config.update("jax_enable_x64", ...)`` mutates global state; the app
runs trainings on background daemon threads (tpinn.app.controller), so two
concurrent jobs toggling the flag for their f64 host-evaluation sections
could interleave save/toggle/restore and leave the flag wrong mid-trace
(nondeterministic retraces, or f64 graphs traced by a job that meant
f32).  Every x64 toggle+restore section in tpinn goes through
``force_x64()`` so the critical sections serialize.  The sections are short
host-side evaluations (train.eval_stage_f64, polish.last_layer_lsq), so
the lock is not a throughput concern.

RESIDUAL RACE (known, accepted): the lock only serializes force_x64
sections against EACH OTHER.  An f32 training that traces OUTSIDE any
force_x64 section while another thread holds the lock still observes
``jax_enable_x64=True`` — the global flag cannot protect code that does not
take the lock.  Exposure in practice: the f32 hot paths trace once at stage
start (scanned Adam phase, jitted L-BFGS) and the x64 sections are
millisecond-scale host evaluations between stages, so the overlap window is
tiny — but concurrent multi-session training (app.controller) can hit it.
Mitigation if it ever bites: run concurrent sessions in separate processes
(serve already does), or replace flag-toggling with explicit f64 dtypes on
the host-eval paths.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import jax

_LOCK = threading.RLock()


@contextmanager
def force_x64():
    """Enable float64 for the duration of the block, restoring the prior
    value on exit; serialized against other force_x64 sections."""
    with _LOCK:
        was = bool(jax.config.jax_enable_x64)
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", was)
