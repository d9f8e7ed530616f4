"""Per-instance failure detection and warm-start recovery.

The batch-scale analog of the reference's in-process failure surfaces
(SURVEY.md §5): solver termination states checked by callers
(``optimization_test.cc:44-46``) and ``Optimization::Reset()`` to discard a
poisoned warm start (``optimization.hpp:83``, ``application.ts:209-214``) —
here vectorized over the batch as ``failure_mask`` + ``reset_where`` and
wired into the closed loop as ``auto_reset``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cartpole_tpu import (
    OptimizationParams,
    default_single_params,
    make_mpc,
    run_closed_loop,
)
from cartpole_tpu.ops.solver import NLSTerminationState

DOWN = np.array([0.0, -np.pi / 2, 0.0, 0.0])


def _outputs_with(mpc, term_code=None, poison_solution=False):
    dp = default_single_params(jnp.float64)
    outputs, state = jax.jit(lambda s, x: mpc.step(s, x, dp))(
        mpc.init_state(jnp.float64), jnp.asarray(DOWN)
    )
    if term_code is not None:
        outputs = outputs._replace(
            solver=outputs.solver._replace(
                termination_state=jnp.asarray(term_code, jnp.int32)
            )
        )
    if poison_solution:
        outputs = outputs._replace(
            solution=outputs.solution.at[0].set(jnp.nan)
        )
    return outputs, state


class TestFailureMask:
    def test_healthy_solve_not_flagged(self):
        mpc = make_mpc(OptimizationParams(max_iterations=3))
        outputs, _ = _outputs_with(mpc)
        assert not bool(mpc.failure_mask(outputs))

    def test_qp_indefinite_flagged(self):
        mpc = make_mpc(OptimizationParams(max_iterations=3))
        outputs, _ = _outputs_with(
            mpc, term_code=NLSTerminationState.QP_INDEFINITE
        )
        assert bool(mpc.failure_mask(outputs))

    def test_max_lambda_flagged(self):
        mpc = make_mpc(OptimizationParams(max_iterations=3))
        outputs, _ = _outputs_with(
            mpc, term_code=NLSTerminationState.MAX_LAMBDA
        )
        assert bool(mpc.failure_mask(outputs))

    def test_nan_solution_flagged(self):
        mpc = make_mpc(OptimizationParams(max_iterations=3))
        outputs, _ = _outputs_with(mpc, poison_solution=True)
        assert bool(mpc.failure_mask(outputs))


class TestResetWhere:
    def test_masked_instances_cold_start(self):
        mpc = make_mpc(OptimizationParams(max_iterations=3))
        dp = default_single_params(jnp.float64)
        n = 4
        states = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(n))
        xs = jnp.tile(jnp.asarray(DOWN), (n, 1))
        _, warm_states = jax.jit(
            jax.vmap(mpc.step, in_axes=(0, 0, None, None))
        )(states, xs, dp, 0.0)
        assert bool(jnp.all(warm_states.warm))

        mask = jnp.asarray([True, False, True, False])
        reset = mpc.reset_where(warm_states, mask)
        warm = np.asarray(reset.warm)
        assert list(warm) == [False, True, False, True]
        prev = np.asarray(reset.previous_solution)
        assert np.all(prev[0] == 0) and np.all(prev[2] == 0)
        assert not np.all(prev[1] == 0)

    def test_reset_instance_reproduces_cold_solve(self):
        mpc = make_mpc(OptimizationParams(max_iterations=3))
        dp = default_single_params(jnp.float64)
        step = jax.jit(lambda s, x: mpc.step(s, x, dp))
        x = jnp.asarray(DOWN)
        out_cold, st = step(mpc.init_state(jnp.float64), x)
        st = mpc.reset_where(st, jnp.asarray(True))
        out_again, _ = step(st, x)
        np.testing.assert_array_equal(
            np.asarray(out_cold.u), np.asarray(out_again.u)
        )


class TestClosedLoopAutoReset:
    def test_failure_free_run_unchanged(self):
        """auto_reset must be a no-op on a healthy trajectory."""
        mpc = make_mpc(OptimizationParams(max_iterations=6, state_spacing=5))
        dp = default_single_params(jnp.float64)
        x0 = jnp.asarray(DOWN)
        res_a = jax.jit(
            lambda x: run_closed_loop(mpc, x, dp, 30, auto_reset=True)
        )(x0)
        res_b = jax.jit(
            lambda x: run_closed_loop(mpc, x, dp, 30, auto_reset=False)
        )(x0)
        term = np.asarray(res_a.termination_states)
        assert not np.any(
            (term == NLSTerminationState.QP_INDEFINITE)
            | (term == NLSTerminationState.MAX_LAMBDA)
        )
        np.testing.assert_array_equal(
            np.asarray(res_a.controls), np.asarray(res_b.controls)
        )


class TestKnockdownDetector:
    """Plant-state knockdown detection (distinct from solver failure):
    MPC.knockdown_mask / knockdown_report. Characterization + reachability
    evidence for the double-pole bench's residual ~1% stuck set lives in
    scripts/probe_knockdowns.py / probe_knockdown_reachability.py."""

    def test_mask_flags_fallen_not_upright(self):
        mpc = make_mpc(OptimizationParams(state_spacing=5))
        up = np.array([0.0, np.pi / 2, 0.0, 0.0])
        tilted = np.array([0.0, np.pi / 2 + 0.3, 0.0, 0.0])
        x = jnp.asarray(np.stack([up, DOWN, tilted]))
        mask = np.asarray(mpc.knockdown_mask(x))
        np.testing.assert_array_equal(mask, [False, True, False])
        # Tighter threshold flags the tilted instance too.
        mask_tight = np.asarray(mpc.knockdown_mask(x, angle_threshold=0.2))
        np.testing.assert_array_equal(mask_tight, [False, True, True])

    def test_mask_wraps_angles(self):
        """2*pi-aliased upright must not be flagged (mod_pi wrap)."""
        mpc = make_mpc(OptimizationParams(state_spacing=5))
        aliased = jnp.asarray([[0.0, np.pi / 2 + 2 * np.pi, 0.0, 0.0]])
        assert not bool(np.asarray(mpc.knockdown_mask(aliased))[0])

    def test_report_first_tick_and_stuck(self):
        mpc = make_mpc(OptimizationParams(state_spacing=5))
        T = 12
        up = [0.0, np.pi / 2, 0.0, 0.0]
        down = [0.0, -np.pi / 2, 0.0, 0.0]
        traj = np.stack([
            np.tile(up, (T, 1)),                           # never down
            np.concatenate([np.tile(up, (4, 1)),
                            np.tile(down, (T - 4, 1))]),   # falls at t=4
            np.concatenate([np.tile(down, (3, 1)),
                            np.tile(up, (T - 3, 1))]),     # recovers
        ])
        down_m, first, stuck = mpc.knockdown_report(
            jnp.asarray(traj), stuck_after=5
        )
        np.testing.assert_array_equal(np.asarray(first), [-1, 4, 0])
        np.testing.assert_array_equal(np.asarray(stuck),
                                      [False, True, False])
        assert np.asarray(down_m).shape == (3, T)

    def test_report_on_real_closed_loop(self):
        """Swing-up trajectory: down early, up at the end, not stuck."""
        mpc = make_mpc(OptimizationParams(max_iterations=6, state_spacing=5))
        dp = default_single_params(jnp.float64)
        res = jax.jit(
            lambda x: run_closed_loop(mpc, x, dp, 120)
        )(jnp.asarray(DOWN))
        down_m, first, stuck = mpc.knockdown_report(
            np.asarray(res.states)[None], stuck_after=20
        )
        assert int(np.asarray(first)[0]) == 0
        assert not bool(np.asarray(stuck)[0])
