"""Scenario-sharded MPC execution with psum-reduced diagnostics.

``shard_map`` over the scenario mesh wraps the vmapped per-instance solve;
the solve itself stays communication-free, and the only collectives are the
global diagnostics reductions (convergence counters, violation maxima —
the batched analog of the reference's per-solve ``NLSSolverOutputs`` health
checks, ``optimization_test.cc:44-46``). XLA hands the ``psum``/``pmax``
all-reduces to NCCL on GPUs.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..mpc.closed_loop import run_closed_loop
from ..mpc.controller import MPC
from ..ops.solver import NLSOutputs, NLSTerminationState
from .mesh import SCENARIO_AXIS

__all__ = [
    "BatchDiagnostics",
    "reduce_diagnostics",
    "make_sharded_step",
    "make_sharded_closed_loop",
]

_N_TERMINATION_STATES = 5


class BatchDiagnostics(NamedTuple):
    """Globally reduced solver health for a batch of MPC instances."""

    n_instances: Any  #: int32 total instances across the mesh.
    n_converged: Any  #: int32 instances that hit a SATISFIED_* state.
    n_failed: Any  #: int32 instances that hit QP_INDEFINITE / MAX_LAMBDA.
    termination_counts: Any  #: (5,) int32 histogram over NLSTerminationState.
    max_violation: Any  #: global max final ||c||_inf.
    max_first_order: Any  #: global max final ||grad L||_inf.
    mean_iterations: Any  #: mean applied solver iterations.
    mean_cost: Any  #: mean final cost.


def _termination_counts(term_flat):
    """Histogram a flat termination-code array (psum-able int32 vector)."""
    return jnp.sum(
        term_flat[:, None]
        == jnp.arange(_N_TERMINATION_STATES, dtype=term_flat.dtype)[None, :],
        axis=0,
        dtype=jnp.int32,
    )


def _converged_failed(counts):
    converged = (
        counts[NLSTerminationState.SATISFIED_RELATIVE_TOL]
        + counts[NLSTerminationState.SATISFIED_FIRST_ORDER_TOL]
    )
    failed = (
        counts[NLSTerminationState.QP_INDEFINITE]
        + counts[NLSTerminationState.MAX_LAMBDA]
    )
    return converged, failed


def _reduced_termination(term_flat, iterations, axis_name):
    """Shared (per-step and closed-loop) reduction of a flat
    termination-code vector + per-solve iteration counts:
    ``(counts, converged, failed, n_solves, mean_iterations)``, psum-ed
    across the mesh when ``axis_name`` is given, local otherwise."""
    counts = _termination_counts(term_flat)
    n = jnp.asarray(term_flat.shape[0], jnp.int32)
    sum_iters = jnp.sum(iterations.astype(jnp.float32))
    if axis_name is not None:
        counts = jax.lax.psum(counts, axis_name)
        n = jax.lax.psum(n, axis_name)
        sum_iters = jax.lax.psum(sum_iters, axis_name)
    converged, failed = _converged_failed(counts)
    mean_iters = sum_iters / jnp.maximum(n.astype(jnp.float32), 1.0)
    return counts, converged, failed, n, mean_iters


def reduce_diagnostics(
    solver: NLSOutputs,
    axis_name: Optional[str] = None,
) -> BatchDiagnostics:
    """Reduce per-instance ``NLSOutputs`` (leading batch axis) to global
    health counters. Inside ``shard_map``, pass ``axis_name`` to reduce
    across the mesh; outside, leave ``None`` for a local reduction.
    """
    counts, converged, failed, n, mean_iters = _reduced_termination(
        solver.termination_state.reshape(-1), solver.n_iterations, axis_name
    )
    max_viol = jnp.max(solver.constraint_violation)
    max_first = jnp.max(solver.first_order_norm)
    sum_cost = jnp.sum(solver.cost.astype(jnp.float32))

    if axis_name is not None:
        max_viol = jax.lax.pmax(max_viol, axis_name)
        max_first = jax.lax.pmax(max_first, axis_name)
        sum_cost = jax.lax.psum(sum_cost, axis_name)

    return BatchDiagnostics(
        n_instances=n,
        n_converged=converged,
        n_failed=failed,
        termination_counts=counts,
        max_violation=max_viol,
        max_first_order=max_first,
        mean_iterations=mean_iters,
        mean_cost=sum_cost / jnp.maximum(n.astype(jnp.float32), 1.0),
    )


def make_sharded_step(
    mpc: MPC,
    mesh: Mesh,
    axis_name: str = SCENARIO_AXIS,
    donate_state: bool = True,
    batched_params: bool = False,
    layout: str = "vmap",
):
    """Build the jitted scenario-sharded batched MPC step.

    Returns ``step(states, xs, dynamics_params, set_points) ->
    (outputs, new_states, BatchDiagnostics)`` where ``states``/``xs``/
    ``set_points`` carry a leading global batch axis sharded over the mesh.
    With ``batched_params=False`` (default) ``dynamics_params`` is one
    replicated plant model for all scenarios; with ``batched_params=True``
    every leaf of ``dynamics_params`` carries the sharded batch axis too —
    the parameter-grid sweeps of BASELINE.json (scenarios x (mass, length)).

    ``layout``: per-shard batching strategy — "vmap" (generic; any
    kkt_method) or "lanes" (the batch-in-lanes condensed fast path,
    ``mpc/lanes.py``; requires ``kkt_method="condensed"``).

    The MPC state is donated by default: warm starts live on-device across
    receding-horizon ticks with zero host round-trips (SURVEY.md §7 hard
    part 6).
    """
    p_axis = 0 if batched_params else None
    p_spec = P(axis_name) if batched_params else P()
    if layout == "lanes":
        from ..mpc.lanes import step_lanes

        batched = lambda st, xs, dp, sp: step_lanes(mpc, st, xs, dp, sp)
    elif layout == "vmap":
        batched = jax.vmap(mpc.step, in_axes=(0, 0, p_axis, 0))
    else:
        raise ValueError(f"unknown layout {layout!r}")

    def local_step(states, xs, dynamics_params, set_points):
        outputs, new_states = batched(states, xs, dynamics_params, set_points)
        diag = reduce_diagnostics(outputs.solver, axis_name)
        return outputs, new_states, diag

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), p_spec, P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P()),
        # Solver scan carries start from unvarying literals; the
        # varying-manual-axes check would reject them even though every
        # instance is independent.
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,) if donate_state else ())


def make_sharded_closed_loop(
    mpc: MPC,
    mesh: Mesh,
    num_steps: int,
    axis_name: str = SCENARIO_AXIS,
    batched_params: bool = False,
    layout: str = "vmap",
):
    """Build the jitted scenario-sharded closed-loop runner.

    Returns ``run(x0s, dynamics_params, set_points) ->
    (ClosedLoopResult, BatchDiagnostics)`` — the whole receding-horizon
    loop (MPC solve -> 1 kHz plant -> warm-start carry) compiled into one
    XLA program per shard, with one diagnostics reduction at the end.
    ``batched_params=True`` gives every scenario its own plant parameters
    (sharded leading axis on each leaf). ``layout``: "vmap" (generic) or
    "lanes" (batch-in-lanes condensed fast path).
    """
    p_axis = 0 if batched_params else None
    p_spec = P(axis_name) if batched_params else P()
    if layout == "lanes":
        from ..mpc.lanes import run_closed_loop_lanes

        batched = lambda x0, dp, sp: run_closed_loop_lanes(
            mpc, x0, dp, num_steps, sp
        )
    elif layout == "vmap":
        batched = jax.vmap(
            lambda x0, dp, sp: run_closed_loop(mpc, x0, dp, num_steps, sp),
            in_axes=(0, p_axis, 0),
        )
    else:
        raise ValueError(f"unknown layout {layout!r}")

    def local_run(x0s, dynamics_params, set_points):
        result = batched(x0s, dynamics_params, set_points)
        counts, converged, failed, _, mean_iters = _reduced_termination(
            result.termination_states.reshape(-1),  # instances * ticks
            result.solver_iterations,
            axis_name,
        )
        diag = BatchDiagnostics(
            n_instances=jax.lax.psum(
                jnp.asarray(x0s.shape[0], jnp.int32), axis_name
            ),
            n_converged=converged,
            n_failed=failed,
            termination_counts=counts,
            max_violation=jax.lax.pmax(
                jnp.max(result.constraint_violations), axis_name
            ),
            max_first_order=jnp.asarray(jnp.nan),  # not tracked per tick
            mean_iterations=mean_iters,
            mean_cost=jnp.asarray(jnp.nan),  # not tracked per tick
        )
        return result, diag

    sharded = jax.shard_map(
        local_run,
        mesh=mesh,
        in_specs=(P(axis_name), p_spec, P(axis_name)),
        out_specs=(P(axis_name), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
