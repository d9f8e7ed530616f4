"""Host-side tracing with Chrome-trace JSON export + jax.profiler hooks.

Parity surface: mini_opt's ``trace_collector`` singleton and its
``get_trace_json()`` Chrome-trace export, reached through the WASM bindings
``isTracingEnabled``/``getTraces`` (``/root/reference/optimization/wasm.cc:122-138``)
and saved by the web UI as ``traces.json``
(``viz/src/application.ts:353-364``). Here the same API traces host-side
phases (problem build, compile, device step, log flush); device-side detail
comes from ``jax.profiler`` via :func:`profiler_trace` (XLA device timelines,
per-kernel cost — the reference's WASM ``--profiling-funcs`` analog).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, Optional

__all__ = [
    "TraceCollector",
    "trace_scope",
    "get_trace_json",
    "is_tracing_enabled",
    "set_tracing_enabled",
    "profiler_trace",
]

_enabled = os.environ.get("CARTPOLE_TPU_TRACING", "") not in ("", "0", "false")


def is_tracing_enabled() -> bool:
    """WASM ``isTracingEnabled`` analog. Unlike the reference's compile-time
    ``MINI_OPT_TRACING`` gate this is a runtime switch (also settable via
    the ``CARTPOLE_TPU_TRACING`` env var)."""
    return _enabled


def set_tracing_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


class TraceCollector:
    """Process-wide collector of complete ('ph':'X') Chrome-trace events."""

    _instance: Optional["TraceCollector"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._t0_us = time.perf_counter_ns() // 1000

    @classmethod
    def get_instance(cls) -> "TraceCollector":
        """Singleton accessor (``trace_collector::get_instance`` analog)."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def record(self, name: str, start_us: int, dur_us: int, **args) -> None:
        event = {
            "name": name,
            "ph": "X",
            "ts": start_us - self._t0_us,
            "dur": dur_us,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    def record_at(self, name: str, ts_us: int, dur_us: int, **args) -> None:
        """Record with an explicit timeline offset (for replaying measured
        device phases onto a synthetic timeline, ts starting at 0)."""
        self.record(name, self._t0_us + ts_us, dur_us, **args)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def get_trace_json(self) -> str:
        """Chrome ``chrome://tracing`` / Perfetto-loadable JSON (the
        ``get_trace_json`` analog)."""
        with self._lock:
            return json.dumps({"traceEvents": list(self._events)})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.get_trace_json())


def get_trace_json() -> str:
    """Module-level convenience mirroring the WASM ``getTraces`` export."""
    if not _enabled:
        return ""
    return TraceCollector.get_instance().get_trace_json()


@contextlib.contextmanager
def trace_scope(name: str, **args) -> Iterator[None]:
    """Time a host-side phase into the collector (no-op when disabled)."""
    if not _enabled:
        yield
        return
    start = time.perf_counter_ns() // 1000
    try:
        yield
    finally:
        end = time.perf_counter_ns() // 1000
        TraceCollector.get_instance().record(name, start, end - start, **args)


@contextlib.contextmanager
def profiler_trace(logdir: str) -> Iterator[None]:
    """Capture a ``jax.profiler`` device trace (TensorBoard/XProf format) —
    per-kernel device timelines."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
