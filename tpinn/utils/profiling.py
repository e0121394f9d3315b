"""Profiling / tracing hooks (SURVEY §5: absent in the reference).

- ``trace(logdir)``: jax.profiler trace context (TensorBoard-compatible);
- ``StepTimer``: wall-clock step timing with ``block_until_ready``
  semantics for honest device timings;
- ``timed(fn)``: one-shot timing helper returning (result, seconds);
- ``PhaseTimer``: wall seconds per named training phase, with the part of
  each that JAX spent tracing, lowering and compiling.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator

import jax

# JAX's own duration events for the three steps of a compilation
# (jax._src.dispatch); they fire in the thread that dispatched the call
_COMPILE_EVENTS = frozenset({
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
})
_compile_secs = threading.local()
_listener_lock = threading.Lock()
_listener_installed = False


def _on_duration_event(event: str, duration: float, **_kw) -> None:
    if event in _COMPILE_EVENTS:
        _compile_secs.total = getattr(_compile_secs, "total", 0.0) + duration


def compile_seconds() -> float:
    """Seconds the calling thread has spent compiling since the listener
    was installed (``PhaseTimer`` installs it)."""
    global _listener_installed
    with _listener_lock:
        if not _listener_installed:
            jax.monitoring.register_event_duration_secs_listener(
                _on_duration_event)
            _listener_installed = True
    return getattr(_compile_secs, "total", 0.0)


class PhaseTimer:
    """Wall and compile seconds per (stage, phase), summed over repeats.

    The wall of a phase includes its device time only where the phase
    ends in a host transfer, as every phase of ``run_training`` does.

    >>> timer = PhaseTimer()
    >>> with timer.phase(1, "adam"):
    ...     run_adam()
    >>> timer.rows()   # [{"stage": 1, "phase": "adam", "wall_s": ..,
    ...                #   "compile_s": ..}]
    """

    def __init__(self):
        self._rows = {}
        compile_seconds()

    @contextlib.contextmanager
    def phase(self, stage: int, name: str):
        c0, t0 = compile_seconds(), time.perf_counter()
        try:
            yield
        finally:
            row = self._rows.setdefault((stage, name), [0.0, 0.0])
            row[0] += time.perf_counter() - t0
            row[1] += compile_seconds() - c0

    def rows(self):
        return [{"stage": s, "phase": n, "wall_s": w, "compile_s": c}
                for (s, n), (w, c) in self._rows.items()]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a profiler trace viewable in TensorBoard / Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Accumulates per-step wall-clock with device completion barriers.

    >>> timer = StepTimer()
    >>> with timer.step():
    ...     out = train_step(...)        # timer blocks on out at exit
    """

    def __init__(self):
        self.times = []
        self._out = None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield self
        if self._out is not None:
            jax.block_until_ready(self._out)
            self._out = None
        self.times.append(time.perf_counter() - t0)

    def observe(self, out):
        """Register device output to block on at step exit."""
        self._out = out
        return out

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> str:
        if not self.times:
            return "no steps recorded"
        ts = sorted(self.times)
        p50 = ts[len(ts) // 2]
        return (f"steps={len(ts)} mean={self.mean*1e3:.2f}ms "
                f"p50={p50*1e3:.2f}ms max={ts[-1]*1e3:.2f}ms")


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 10):
    """(result, secs_per_call) with compile excluded and device barriers."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / iters
