"""Time-varying cost schedules: phase-scheduled closed-loop runs.

The round-4 double-pole work measured
(``scripts/probe_transient_shaping.py``, dose-response verified) that a
transient-only override of the cost weights — an 8x
``u_derivative_cost_weight`` during the first ~50 cold-start ticks —
prevents high-energy tumbling knockdowns at the SOURCE, while the same
weight applied forever is *worse* than baseline. That mechanism deserves a
product API, not a bench constant: :func:`run_scheduled_closed_loop` runs
a closed loop through an explicit schedule of ``(num_ticks, overrides)``
phases, rebuilding the controller per phase and carrying the plant state
and warm start across phase boundaries.

Design notes (why phases, not a tick-indexed weight array): the cost
weights are STATIC solver structure — ``u_cost_weight`` /
``u_derivative_cost_weight`` build the precomputed u-cost Gram matrix and
its eigendecomposition (``mpc/lanes.py::_LanesProblem.__init__``), and
terminal weights select the condensed KKT's Schur diagonal — so a weight
change is a different compiled program, not a different operand. A
schedule therefore compiles one program per DISTINCT override set (phases
repeating an override reuse the compiled runner) and chains them on the
host, exactly like the reference UI rebuilds its optimizer when sliders
change (``viz/src/application.ts:279-373``) — at phase boundaries instead
of browser events.

Phases must keep the decision-vector layout fixed (same ``window_length``,
``state_spacing``, model): the warm start carries across boundaries as-is.
Long phases are internally split into chunks of ``max_ticks_per_program``
(default 50); the split costs one dispatch per chunk, nothing more.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .closed_loop import ClosedLoopResult, run_closed_loop
from .controller import MPC, MPCState, make_mpc

__all__ = ["run_scheduled_closed_loop"]

#: Schedule entry: (number of ticks, OptimizationParams field overrides).
#: ``None`` or ``{}`` overrides mean "the base controller".
ScheduleEntry = Tuple[int, Optional[Mapping[str, Any]]]


def _phase_mpc(mpc: MPC, overrides: Optional[Mapping[str, Any]]) -> MPC:
    if not overrides:
        return mpc
    params = dataclasses.replace(mpc.params, **dict(overrides))
    phase = make_mpc(params, mpc.model)
    if phase.spec.dim != mpc.spec.dim:
        raise ValueError(
            "schedule overrides must preserve the decision-vector layout "
            "(window_length / state_spacing change the warm-start shape): "
            f"dim {mpc.spec.dim} -> {phase.spec.dim} via {dict(overrides)}"
        )
    return phase


def _concat_results(parts: Sequence[ClosedLoopResult],
                    tick_axis: int) -> ClosedLoopResult:
    last = parts[-1]
    cat = lambda xs: jnp.concatenate(xs, axis=tick_axis)
    return ClosedLoopResult(
        final_state=last.final_state,
        final_mpc_state=last.final_mpc_state,
        states=cat([p.states for p in parts]),
        controls=cat([p.controls for p in parts]),
        terminal_predictions=cat([p.terminal_predictions for p in parts]),
        termination_states=cat([p.termination_states for p in parts]),
        constraint_violations=cat([p.constraint_violations for p in parts]),
        solver_iterations=cat([p.solver_iterations for p in parts]),
    )


def run_scheduled_closed_loop(
    mpc: MPC,
    x0,
    dynamics_params,
    schedule: Sequence[ScheduleEntry],
    set_point=0.0,
    mpc_state: Optional[MPCState] = None,
    layout: str = "single",
    auto_reset: bool = True,
    max_ticks_per_program: int = 50,
    use_jit: bool = True,
) -> ClosedLoopResult:
    """Run a closed loop through a schedule of solver-parameter phases.

    ``schedule`` is a sequence of ``(num_ticks, overrides)``:
    ``overrides`` is a dict of ``OptimizationParams`` fields (e.g.
    ``{"u_derivative_cost_weight": 0.8}``) or ``None`` for the base
    controller. Plant state and warm start chain across phases; the
    result is one :class:`ClosedLoopResult` covering every tick.

    ``layout="single"`` runs one instance via :func:`run_closed_loop`
    (``x0`` is ``(sd,)``); ``layout="lanes"`` runs a batch via the
    batch-in-lanes fast path (``x0`` is ``(B, sd)``).

    Distinct override sets compile once each and are reused across the
    schedule (and across chunks within a phase). Phases longer than
    ``max_ticks_per_program`` ticks are split into same-shaped chunks of
    one compiled program each.
    """
    if layout not in ("single", "lanes"):
        raise ValueError(f"unknown layout {layout!r}")
    if not schedule:
        raise ValueError("schedule must have at least one phase")
    chunk = int(max_ticks_per_program)
    if chunk < 1:
        raise ValueError("max_ticks_per_program must be >= 1")

    x = jnp.asarray(x0)
    dtype = x.dtype
    if mpc_state is None:
        if layout == "lanes":
            B = x.shape[0]
            mpc_state = MPCState(
                previous_solution=jnp.zeros((B, mpc.spec.dim), dtype),
                warm=jnp.zeros((B,), bool),
            )
        else:
            mpc_state = mpc.init_state(dtype)

    runners: dict = {}  # (override key, n_ticks) -> compiled runner

    def runner(phase_mpc: MPC, key, n_ticks: int):
        rkey = (key, n_ticks)
        if rkey in runners:
            return runners[rkey]
        if layout == "lanes":
            from .lanes import run_closed_loop_lanes

            def run(x_, st_):
                return run_closed_loop_lanes(
                    phase_mpc, x_, dynamics_params, n_ticks, set_point,
                    mpc_state=st_, auto_reset=auto_reset,
                )
        else:
            def run(x_, st_):
                return run_closed_loop(
                    phase_mpc, x_, dynamics_params, n_ticks, set_point,
                    mpc_state=st_, auto_reset=auto_reset,
                )
        if use_jit:
            run = jax.jit(run)
        runners[rkey] = run
        return run

    parts = []
    state = mpc_state
    for n_ticks, overrides in schedule:
        n_ticks = int(n_ticks)
        if n_ticks < 1:
            raise ValueError("each schedule phase needs >= 1 ticks")
        key = tuple(sorted(dict(overrides or {}).items()))
        phase_mpc = _phase_mpc(mpc, overrides)
        remaining = n_ticks
        while remaining > 0:
            n = min(remaining, chunk)
            res = runner(phase_mpc, key, n)(x, state)
            parts.append(res)
            x = res.final_state
            state = res.final_mpc_state
            remaining -= n
    return _concat_results(parts, tick_axis=1 if layout == "lanes" else 0)
