"""Alternate KKT solver paths: parity with the LU path.

Two fast paths replace the symmetric-indefinite LU factorization
(``NLSConfig.kkt_method``): "schur" — two SPD Cholesky solves on the
equilibrated augmented system (ops/solver.py); "condensed" — exact
elimination of the block-bidiagonal defect+pin rows down to a K-var SPD
system (mpc/problem.py). Both must reproduce the LU path's solutions and
pass the reference closed-loop gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpole_tpu import (
    OptimizationParams,
    default_single_params,
    make_mpc,
    run_closed_loop,
)
from cartpole_tpu.ops.solver import NLSTerminationState

DOWN = np.array([0.0, -np.pi / 2, 0.0, 0.0])

METHODS = ("schur", "condensed")


def _mpc(method):
    return make_mpc(
        OptimizationParams(
            max_iterations=10, state_spacing=5, kkt_method=method
        )
    )


class TestAltKKTParity:
    @pytest.mark.parametrize("method", METHODS)
    def test_single_solve_matches_lu(self, method):
        """Same linear systems, so iterates stay close in f64. (Exact
        equality is not expected: the LU path's -1e-10 constraint-block
        regularization perturbs dz by ~|nu|*1e-10 ~ 1e-3 per step, and the
        line search amplifies last-ulp differences.)"""
        dp = default_single_params(jnp.float64)
        x0 = jnp.asarray(DOWN)
        out_lu, _ = jax.jit(
            lambda s, x: _mpc("lu").step(s, x, dp)
        )(_mpc("lu").init_state(jnp.float64), x0)
        out_m, _ = jax.jit(
            lambda s, x: _mpc(method).step(s, x, dp)
        )(_mpc(method).init_state(jnp.float64), x0)
        np.testing.assert_allclose(
            np.asarray(out_m.u), np.asarray(out_lu.u), rtol=0, atol=0.5
        )

    @pytest.mark.parametrize("method", METHODS)
    def test_closed_loop_meets_reference_thresholds(self, method):
        """Full 250-tick swing-up through each path passes the same gates
        as the LU path (optimization_test.cc thresholds)."""
        dp = default_single_params(jnp.float64)
        res = jax.jit(
            lambda x: run_closed_loop(_mpc(method), x, dp, 250)
        )(jnp.asarray(DOWN))
        term = np.asarray(res.termination_states)
        assert not np.any(
            (term == NLSTerminationState.QP_INDEFINITE)
            | (term == NLSTerminationState.MAX_LAMBDA)
        )
        xf = np.asarray(res.final_state)
        assert abs(xf[1] - np.pi / 2) < 1e-4
        assert abs(xf[2]) < 1e-4
        assert abs(xf[3]) < 1e-3
        tp = np.asarray(res.terminal_predictions)[21:]
        np.testing.assert_array_less(np.abs(tp[:, 1] - np.pi / 2), 1e-4)
        assert np.asarray(res.constraint_violations)[21:].max() < 1e-4

    @pytest.mark.parametrize("method", METHODS)
    def test_u_sequence_close_to_lu_path(self, method):
        dp = default_single_params(jnp.float64)
        run_lu = jax.jit(lambda x: run_closed_loop(_mpc("lu"), x, dp, 100))
        run_m = jax.jit(
            lambda x: run_closed_loop(_mpc(method), x, dp, 100)
        )
        u_lu = np.asarray(run_lu(jnp.asarray(DOWN)).controls)
        u_m = np.asarray(run_m(jnp.asarray(DOWN)).controls)
        # Iterates diverge slightly mid-swing (different rounding paths);
        # bounded drift, same trajectory.
        assert np.abs(u_lu - u_m).max() < 0.5

    def test_first_order_semantics_unified(self):
        """``first_order_norm`` reports the same quantity in every KKT path
        — the full-z Lagrangian-gradient inf-norm ``||J^T r + A^T nu||_inf``
        with the path's multiplier estimates (the condensed path recovers
        the eliminated defect/pin multipliers by an adjoint pass, so its
        state rows vanish exactly and the norm reduces to the control
        rows). On an interior (no binding retraction clamp) stabilization
        problem every path must drive it below the first-order tolerance
        and terminate SATISFIED_FIRST_ORDER_TOL. (Swing-up is excluded:
        there the u clamp binds and the unconstrained gradient legitimately
        stays nonzero.)"""
        dp = default_single_params(jnp.float64)
        x0 = jnp.asarray([0.0, np.pi / 2 - 0.05, 0.0, 0.0])
        for method in ("lu", "schur", "condensed"):
            p_conv = OptimizationParams(
                max_iterations=40, state_spacing=5, kkt_method=method,
                relative_exit_tol=0.0,
            )
            mpc = make_mpc(p_conv)
            out, _ = jax.jit(
                lambda s, x, m=mpc: m.step(s, x, dp)
            )(mpc.init_state(jnp.float64), x0)
            assert (
                int(out.solver.termination_state)
                == NLSTerminationState.SATISFIED_FIRST_ORDER_TOL
            ), method
            assert float(out.solver.first_order_norm) < 1.0e-6, method

    def test_condensed_step_satisfies_linearized_constraints(self):
        """The condensed step eliminates defects+pins EXACTLY: its dz
        satisfies the dense path's linearized constraints to roundoff."""
        from cartpole_tpu.ops.integrate import rollout

        dp = default_single_params(jnp.float64)
        x0 = jnp.asarray(DOWN)
        mpc = _mpc("condensed")
        spec = mpc.spec
        u_guess, u_prev = mpc._initial_guess(
            mpc.init_state(jnp.float64), x0
        )
        f = lambda x, u: mpc.model.dynamics(dp, x, u)
        _, xs_roll = rollout(f, x0, u_guess, 0.01, mpc.model.angle_indices)
        shoot = jnp.concatenate(
            [x0[None, :], xs_roll[spec.spacing - 1 :: spec.spacing]], axis=0
        )
        z = jnp.concatenate([shoot.reshape(-1), u_guess])

        zero = jnp.zeros((), jnp.float64)
        lin, _, _ = spec.make_problem_fns(x0, zero, u_prev, dp)
        cstep = spec.make_condensed_step(x0, zero, u_prev, dp)
        r, J, c, A = lin(z)
        dz, nu_inf, first_order, jr_dz, ok, r_c, c_c = cstep(z, zero)
        assert bool(ok)
        assert float(jnp.abs(A @ dz + c).max()) < 1e-8
        # Exact directional derivative matches the dense computation.
        np.testing.assert_allclose(
            float(jr_dz), float(jnp.vdot(J.T @ r, dz)), rtol=1e-6
        )
        # The returned residual/constraint values match the dense path.
        np.testing.assert_allclose(np.asarray(r_c), np.asarray(r), atol=1e-12)
        np.testing.assert_allclose(np.asarray(c_c), np.asarray(c), atol=1e-12)
