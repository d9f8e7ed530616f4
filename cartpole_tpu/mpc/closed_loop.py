"""Closed-loop receding-horizon driver.

In the reference the closed loop lives at the *top* of the stack: the browser
frame loop or test code alternates ``optimizer.step()`` and
``simulator.step()`` on the host
(``/root/reference/viz/src/application.ts:424-458``,
``optimization/optimization_test.cc:39-61``). On an accelerator that host
round-trip per control tick would dominate, so the loop itself is a ``lax.scan`` compiled
into one XLA program: MPC solve -> apply ``u[0]`` to the 1 kHz plant ->
carry the warm start. The whole loop vmaps over scenarios and shard_maps over
a device mesh.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .controller import MPC, MPCState
from .simulator import simulator_step

__all__ = ["ClosedLoopResult", "run_closed_loop", "closed_loop_step"]


class ClosedLoopResult(NamedTuple):
    final_state: Any  #: (state_dim,) plant state after the last step.
    final_mpc_state: MPCState
    states: Any  #: (num_steps, state_dim) plant state at each tick (pre-step).
    controls: Any  #: (num_steps,) applied u[0] at each tick.
    terminal_predictions: Any  #: (num_steps, state_dim) predicted terminal state.
    termination_states: Any  #: (num_steps,) solver termination codes.
    constraint_violations: Any  #: (num_steps,) final ||c||_inf per solve.
    solver_iterations: Any  #: (num_steps,) iterations used per solve.


def closed_loop_step(mpc: MPC, carry, dynamics_params, set_point,
                     auto_reset: bool = True, f_base=None, f_mass=None):
    """One control tick: solve, apply u[0] to the plant for ``control_dt``.

    With ``auto_reset`` (default), a failed solve (QP_INDEFINITE /
    MAX_LAMBDA / non-finite solution) discards the warm start so the next
    tick cold-starts instead of iterating on a poisoned guess — the batch-
    scale analog of the reference UI's ``Reset()`` on re-enable
    (``application.ts:209-214``); its control output is suppressed to 0 for
    the tick (the web app applies 0 when the controller is off,
    ``application.ts:437-442``).

    ``f_base``/``f_mass`` are external disturbance forces (2-vectors)
    applied to the PLANT only — the planner never sees them, exactly like
    the browser UI's mouse-injected pokes (``application.ts:424-458``).
    """
    x, mpc_state = carry
    outputs, mpc_state = mpc.step(mpc_state, x, dynamics_params, set_point)
    u0 = outputs.u[0]
    if auto_reset:
        failed = mpc.failure_mask(outputs)
        mpc_state = mpc.reset_where(mpc_state, failed)
        u0 = jnp.where(failed, jnp.zeros_like(u0), u0)
    x_next = simulator_step(
        dynamics_params, x, mpc.params.control_dt, u0,
        f_base, f_mass, model=mpc.model,
    )
    return (x_next, mpc_state), (outputs, u0)


def run_closed_loop(
    mpc: MPC,
    x0,
    dynamics_params,
    num_steps: int,
    set_point=0.0,
    mpc_state: MPCState | None = None,
    auto_reset: bool = True,
    disturbances=None,
) -> ClosedLoopResult:
    """Run ``num_steps`` receding-horizon ticks (the reference's 200-step
    closed-loop test pattern, ``optimization_test.cc:39-61``) as one scan.

    Pure function; ``vmap`` over a leading axis of ``x0`` /
    ``dynamics_params`` for batched scenario studies.

    ``disturbances``: optional ``(num_steps, 2, 2)`` array of external
    plant forces per tick — ``[:, 0]`` at the base, ``[:, 1]`` at the pole
    mass; the planner never sees them (the browser UI's user-poke
    semantics).
    """
    x0 = jnp.asarray(x0)
    if mpc_state is None:
        mpc_state = mpc.init_state(x0.dtype)
    set_point = jnp.asarray(set_point, x0.dtype)
    if disturbances is not None:
        disturbances = jnp.asarray(disturbances, x0.dtype)

    def body(carry, dist):
        (x, state) = carry
        f_base = dist[0] if dist is not None else None
        f_mass = dist[1] if dist is not None else None
        (x_next, state_next), (outputs, u0) = closed_loop_step(
            mpc, (x, state), dynamics_params, set_point, auto_reset,
            f_base, f_mass,
        )
        tick = (
            x,
            u0,
            outputs.predicted_states[-1],
            outputs.solver.termination_state,
            outputs.solver.constraint_violation,
            outputs.solver.n_iterations,
        )
        return (x_next, state_next), tick

    (x_final, mpc_state_final), ticks = jax.lax.scan(
        body, (x0, mpc_state), disturbances, length=num_steps
    )
    states, controls, term_pred, term_codes, violations, iters = ticks
    return ClosedLoopResult(
        final_state=x_final,
        final_mpc_state=mpc_state_final,
        states=states,
        controls=controls,
        terminal_predictions=term_pred,
        termination_states=term_codes,
        constraint_violations=violations,
        solver_iterations=iters,
    )
