"""Observability & persistence: tracing, structured solve logs, checkpoints.

Equivalents of the reference's auxiliary subsystems (SURVEY.md §5):
mini_opt's compile-time-gated Chrome-trace collector becomes a host-side
trace collector plus ``jax.profiler`` integration; the web app's JSON solve
log becomes :class:`SolveLog`; the implicit "warm start == resumable state"
contract becomes explicit checkpoint save/load of solver-state PyTrees.
"""

from .checkpoint import (
    load_state,
    load_state_orbax,
    save_state,
    save_state_orbax,
)
from .debug import (
    DebugCheckError,
    assert_all_finite,
    checked,
    debug_mode,
    leak_check,
)
from .logging import SolveLog, solve_log_entry, solver_summary
from .replay import LogReplay, load_log, replay_log
from .tracing import (
    TraceCollector,
    get_trace_json,
    is_tracing_enabled,
    profiler_trace,
    set_tracing_enabled,
    trace_scope,
)

__all__ = [
    "LogReplay",
    "SolveLog",
    "TraceCollector",
    "get_trace_json",
    "is_tracing_enabled",
    "leak_check",
    "load_log",
    "load_state",
    "load_state_orbax",
    "replay_log",
    "profiler_trace",
    "save_state",
    "save_state_orbax",
    "set_tracing_enabled",
    "solve_log_entry",
    "solver_summary",
    "trace_scope",
]
