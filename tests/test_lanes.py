"""Batch-in-lanes hot path: equivalence with the vmapped reference path.

The lanes layout (``mpc/lanes.py``, ``ops/lanes.py``) is a pure memory-
layout rewrite of the condensed MPC step: identical problem structure,
globalization, and diagnostics. These tests pin tick-for-tick equivalence
against ``vmap(MPC.step)`` in f64, where the only differences are rounding
(analytic closed-form Jacobians vs ``jacfwd`` agree to ~1e-11; everything
else is the same arithmetic reordered).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpole_tpu import (
    OptimizationParams,
    default_double_params,
    default_single_params,
    make_mpc,
    run_closed_loop,
)
from cartpole_tpu.models import DOUBLE_CARTPOLE
from cartpole_tpu.mpc.controller import MPCState
from cartpole_tpu.mpc.lanes import (
    run_closed_loop_lanes,
    simulator_step_lanes,
    step_lanes,
)
from cartpole_tpu.mpc.simulator import simulator_step
from cartpole_tpu.ops.solver import NLSTerminationState

DOWN = np.array([0.0, -np.pi / 2, 0.0, 0.0])


def _x0_batch(B, seed=0, dim=4):
    rng = np.random.RandomState(seed)
    base = [0.0, -np.pi / 2, 0.0, 0.0] if dim == 4 else [
        0.0, -np.pi / 2, -np.pi / 2, 0.0, 0.0, 0.0
    ]
    x0 = np.tile(base, (B, 1))
    x0[:, 0] += rng.uniform(-0.5, 0.5, B)
    x0[:, 1] += rng.uniform(-0.5, 0.5, B)
    return jnp.asarray(x0)


def _init_lanes_state(mpc, B, dtype=jnp.float64):
    return MPCState(
        previous_solution=jnp.zeros((B, mpc.spec.dim), dtype),
        warm=jnp.zeros((B,), bool),
    )


def _mpc(**kw):
    kw.setdefault("max_iterations", 8)
    kw.setdefault("state_spacing", 5)
    kw.setdefault("kkt_method", "condensed")
    return make_mpc(OptimizationParams(**kw))


class TestStepEquivalence:
    def test_matches_vmapped_analytic_condensed(self):
        """Same Jacobians (machine-generated), same condensed step: lanes
        must agree with the vmapped path to near machine precision."""
        B = 6
        mpc = _mpc(analytic_jacobians=True)
        dp = default_single_params(jnp.float64)
        x0 = _x0_batch(B)
        sp = jnp.zeros((B,), jnp.float64)
        st_v = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(B))
        out_v, st2_v = jax.jit(
            jax.vmap(mpc.step, in_axes=(0, 0, None, 0))
        )(st_v, x0, dp, sp)
        out_l, st2_l = jax.jit(
            lambda s, x, d, p: step_lanes(mpc, s, x, d, p)
        )(_init_lanes_state(mpc, B), x0, dp, sp)

        np.testing.assert_allclose(
            np.asarray(out_l.u), np.asarray(out_v.u), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(out_l.solution), np.asarray(out_v.solution), atol=1e-9
        )
        np.testing.assert_array_equal(
            np.asarray(out_l.solver.termination_state),
            np.asarray(out_v.solver.termination_state),
        )
        np.testing.assert_array_equal(
            np.asarray(out_l.solver.n_iterations),
            np.asarray(out_v.solver.n_iterations),
        )
        np.testing.assert_allclose(
            np.asarray(out_l.solver.first_order_norm),
            np.asarray(out_v.solver.first_order_norm),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(out_l.predicted_states),
            np.asarray(out_v.predicted_states),
            atol=1e-9,
        )
        # Guess (previous_solution output) is bit-identical arithmetic.
        np.testing.assert_allclose(
            np.asarray(out_l.previous_solution),
            np.asarray(out_v.previous_solution),
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(st2_l.previous_solution),
            np.asarray(st2_v.previous_solution),
            atol=1e-9,
        )

    def test_matches_default_jacfwd_path(self):
        """Against the default (jacfwd) vmapped condensed path the only
        extra difference is analytic-vs-AD Jacobians (~1e-11)."""
        B = 4
        mpc = _mpc()  # analytic_jacobians=False: vmap uses jacfwd
        dp = default_single_params(jnp.float64)
        x0 = _x0_batch(B, seed=3)
        sp = jnp.zeros((B,), jnp.float64)
        st_v = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(B))
        out_v, _ = jax.jit(
            jax.vmap(mpc.step, in_axes=(0, 0, None, 0))
        )(st_v, x0, dp, sp)
        out_l, _ = jax.jit(
            lambda s, x, d, p: step_lanes(mpc, s, x, d, p)
        )(_init_lanes_state(mpc, B), x0, dp, sp)
        np.testing.assert_allclose(
            np.asarray(out_l.u), np.asarray(out_v.u), atol=1e-6
        )

    def test_warm_start_path(self):
        """Second tick (warm start) also matches."""
        B = 4
        mpc = _mpc(analytic_jacobians=True)
        dp = default_single_params(jnp.float64)
        x0 = _x0_batch(B, seed=5)
        sp = jnp.zeros((B,), jnp.float64)
        st_v = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(B))
        step_v = jax.jit(jax.vmap(mpc.step, in_axes=(0, 0, None, 0)))
        step_l = jax.jit(lambda s, x, d, p: step_lanes(mpc, s, x, d, p))
        out_v, st_v = step_v(st_v, x0, dp, sp)
        out_l, st_l = step_l(_init_lanes_state(mpc, B), x0, dp, sp)
        # advance plant with the vmapped u for both
        x1 = jax.vmap(
            lambda x, u: simulator_step(dp, x, 0.01, u)
        )(x0, out_v.u[:, 0])
        out_v2, _ = step_v(st_v, x1, dp, sp)
        # hand the lanes path the SAME carried state to isolate the step
        out_l2, _ = step_l(st_v, x1, dp, sp)
        np.testing.assert_allclose(
            np.asarray(out_l2.u), np.asarray(out_v2.u), atol=1e-8
        )

    def test_per_instance_dynamics_params(self):
        """A per-instance (mass, length) grid — the BASELINE config-5
        sweep shape — gives each lane its own plant, as vmap does."""
        import dataclasses

        B = 4
        mpc = _mpc(analytic_jacobians=True)
        grid = np.stack(np.meshgrid([0.08, 0.12], [0.2, 0.3]),
                        -1).reshape(B, 2)
        dp = dataclasses.replace(
            jax.tree.map(lambda v: jnp.broadcast_to(v, (B,)),
                         default_single_params(jnp.float64)),
            m_1=jnp.asarray(grid[:, 0]), l_1=jnp.asarray(grid[:, 1]),
        )
        x0 = _x0_batch(B, seed=11)
        sp = jnp.zeros((B,), jnp.float64)
        st_v = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(B))
        out_v, _ = jax.jit(
            jax.vmap(mpc.step, in_axes=(0, 0, 0, 0))
        )(st_v, x0, dp, sp)
        out_l, _ = jax.jit(
            lambda s, x, d, p: step_lanes(mpc, s, x, d, p)
        )(_init_lanes_state(mpc, B), x0, dp, sp)
        np.testing.assert_allclose(
            np.asarray(out_l.u), np.asarray(out_v.u), atol=1e-8
        )
        np.testing.assert_array_equal(
            np.asarray(out_l.solver.termination_state),
            np.asarray(out_v.solver.termination_state),
        )
        # The grid must actually matter: different plants, different u.
        u = np.asarray(out_l.u)
        assert np.abs(u[0] - u[-1]).max() > 1e-3

    def test_warm_start_with_binding_bounds(self):
        """Warm-started ticks with a binding control limit (the line
        search clamps u) stay equivalent tick for tick."""
        B = 3
        mpc = _mpc(analytic_jacobians=True, u_limit=20.0)
        dp = default_single_params(jnp.float64)
        x = _x0_batch(B, seed=3)
        sp = jnp.zeros((B,), jnp.float64)
        step_v = jax.jit(jax.vmap(mpc.step, in_axes=(0, 0, None, 0)))
        step_l = jax.jit(lambda s, x_, d, p: step_lanes(mpc, s, x_, d, p))
        st_v = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(B))
        st_l = _init_lanes_state(mpc, B)
        u_max = 0.0
        for _ in range(3):
            out_v, st_v = step_v(st_v, x, dp, sp)
            out_l, st_l = step_l(st_l, x, dp, sp)
            np.testing.assert_allclose(
                np.asarray(out_l.u), np.asarray(out_v.u), atol=1e-7
            )
            u_max = max(u_max, float(np.abs(np.asarray(out_l.u)).max()))
            # Drive both with the vmapped one-step prediction so the
            # state inputs stay identical across ticks.
            x = out_v.predicted_states[:, 0, :]
        assert np.isclose(u_max, 20.0)  # the limit did bind

    def test_rejects_non_condensed(self):
        mpc = _mpc(kkt_method="lu")
        dp = default_single_params(jnp.float64)
        with pytest.raises(ValueError, match="condensed"):
            step_lanes(mpc, _init_lanes_state(mpc, 2), _x0_batch(2), dp)

    def test_double_pole_model(self):
        """Lanes is generic over the model family (6-state double pole)."""
        B = 3
        params = OptimizationParams(
            max_iterations=8,
            state_spacing=5,
            window_length=60,
            kkt_method="condensed",
            analytic_jacobians=True,
            th_final_cost_weight=-1.0,
        )
        mpc = make_mpc(params, DOUBLE_CARTPOLE)
        dp = default_double_params(jnp.float64)
        rng = np.random.RandomState(2)
        x0 = np.tile([0.0, np.pi / 2, np.pi / 2, 0.0, 0.0, 0.0], (B, 1))
        x0[:, 1] += rng.uniform(-0.05, 0.05, B)
        x0 = jnp.asarray(x0)
        sp = jnp.zeros((B,), jnp.float64)
        st_v = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(B))
        out_v, _ = jax.jit(
            jax.vmap(mpc.step, in_axes=(0, 0, None, 0))
        )(st_v, x0, dp, sp)
        out_l, _ = jax.jit(
            lambda s, x, d, p: step_lanes(mpc, s, x, d, p)
        )(_init_lanes_state(mpc, B), x0, dp, sp)
        np.testing.assert_allclose(
            np.asarray(out_l.u), np.asarray(out_v.u), atol=1e-8
        )


class TestClosedLoopEquivalence:
    def test_matches_vmapped_closed_loop(self):
        B = 4
        mpc = _mpc(analytic_jacobians=True)
        dp = default_single_params(jnp.float64)
        x0 = _x0_batch(B, seed=1)
        sp = jnp.zeros((B,), jnp.float64)
        res_v = jax.jit(
            jax.vmap(
                lambda x, s: run_closed_loop(mpc, x, dp, 40, s),
                in_axes=(0, 0),
            )
        )(x0, sp)
        res_l = jax.jit(
            lambda x, s: run_closed_loop_lanes(mpc, x, dp, 40, s)
        )(x0, sp)
        np.testing.assert_allclose(
            np.asarray(res_l.controls), np.asarray(res_v.controls), atol=1e-7
        )
        np.testing.assert_allclose(
            np.asarray(res_l.states), np.asarray(res_v.states), atol=1e-9
        )
        np.testing.assert_array_equal(
            np.asarray(res_l.termination_states),
            np.asarray(res_v.termination_states),
        )

    def test_swingup_meets_reference_thresholds(self):
        """The lanes loop passes the same closed-loop gates as every other
        path (optimization_test.cc:51-66 magnitudes at 250 ticks)."""
        mpc = make_mpc(
            OptimizationParams(
                max_iterations=10, state_spacing=5, kkt_method="condensed"
            )
        )
        dp = default_single_params(jnp.float64)
        x0 = jnp.asarray(DOWN)[None, :]
        res = jax.jit(
            lambda x: run_closed_loop_lanes(mpc, x, dp, 250)
        )(x0)
        term = np.asarray(res.termination_states)
        assert not np.any(
            (term == NLSTerminationState.QP_INDEFINITE)
            | (term == NLSTerminationState.MAX_LAMBDA)
        )
        xf = np.asarray(res.final_state)[0]
        assert abs(xf[1] - np.pi / 2) < 1e-4
        assert abs(xf[2]) < 1e-4
        assert abs(xf[3]) < 1e-3

    def test_batched_dynamics_params(self):
        """Per-instance plant parameters (the sweep capability) fold
        through the lanes layout."""
        B = 4
        mpc = _mpc(analytic_jacobians=True)
        base = default_single_params(jnp.float64)
        import dataclasses

        dp = dataclasses.replace(
            base,
            m_1=jnp.linspace(0.08, 0.14, B, dtype=jnp.float64),
            l_1=jnp.linspace(0.2, 0.3, B, dtype=jnp.float64),
        )
        # vmap in_axes=0 over the params tree needs every leaf batched.
        dp = jax.tree.map(lambda v: jnp.broadcast_to(v, (B,)), dp)
        x0 = _x0_batch(B, seed=7)
        sp = jnp.zeros((B,), jnp.float64)
        res_v = jax.jit(
            jax.vmap(
                lambda x, d, s: run_closed_loop(mpc, x, d, 30, s),
                in_axes=(0, 0, 0),
            )
        )(x0, dp, sp)
        res_l = jax.jit(
            lambda x, d, s: run_closed_loop_lanes(mpc, x, d, 30, s)
        )(x0, dp, sp)
        np.testing.assert_allclose(
            np.asarray(res_l.controls), np.asarray(res_v.controls), atol=1e-7
        )

    def test_disturbances(self):
        """External poke forces reach the lanes plant (planner-invisible)."""
        B, T = 3, 20
        mpc = _mpc(analytic_jacobians=True)
        dp = default_single_params(jnp.float64)
        x0 = _x0_batch(B, seed=9)
        sp = jnp.zeros((B,), jnp.float64)
        dist = np.zeros((B, T, 2, 2))
        dist[:, 5:10, 1, 0] = 30.0  # x-force at the pole mass
        dist = jnp.asarray(dist)
        res_v = jax.jit(
            jax.vmap(
                lambda x, s, d: run_closed_loop(
                    mpc, x, dp, T, s, disturbances=d
                ),
                in_axes=(0, 0, 0),
            )
        )(x0, sp, dist)
        res_l = jax.jit(
            lambda x, s, d: run_closed_loop_lanes(
                mpc, x, dp, T, s, disturbances=d
            )
        )(x0, sp, dist)
        np.testing.assert_allclose(
            np.asarray(res_l.states), np.asarray(res_v.states), atol=1e-8
        )
        # and the disturbance visibly alters the trajectory
        res0 = jax.jit(
            lambda x, s: run_closed_loop_lanes(mpc, x, dp, T, s)
        )(x0, sp)
        assert (
            np.abs(
                np.asarray(res0.states) - np.asarray(res_l.states)
            ).max() > 1e-3
        )


class TestLanesSimulator:
    def test_matches_per_instance_simulator(self):
        B = 5
        dp = default_single_params(jnp.float64)
        rng = np.random.RandomState(4)
        x = jnp.asarray(rng.uniform(-1, 1, (B, 4)))
        u = jnp.asarray(rng.uniform(-50, 50, B))
        from cartpole_tpu.models import SINGLE_CARTPOLE

        want = jax.vmap(
            lambda x_, u_: simulator_step(dp, x_, 0.01, u_)
        )(x, u)
        got = simulator_step_lanes(
            dp, x.T, 0.01, u, model=SINGLE_CARTPOLE
        ).T
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), atol=1e-12
        )


class TestRolloutUnroll:
    """`rollout_rows(..., unroll=)` is a pure scheduling knob: trajectories
    must be bitwise identical across unroll factors, and the Jacobian
    chain-products identical to ~1 ULP (XLA may refuse different
    mul/add fusions per loop structure, reassociating one rounding)."""

    def test_unroll_equivalence(self):
        from cartpole_tpu.models.base import SINGLE_CARTPOLE
        from cartpole_tpu.ops.lanes import rollout_rows

        dp = default_single_params(jnp.float64)
        rng = np.random.RandomState(7)
        M, T = 33, 11
        x0 = tuple(jnp.asarray(rng.uniform(-1, 1, M)) for _ in range(4))
        us = jnp.asarray(rng.uniform(-5, 5, (T, M)))
        fr = lambda xr, u_: SINGLE_CARTPOLE.dynamics_core(dp, xr, u_)

        ref = rollout_rows(fr, x0, us, 0.01, (1,), unroll=1)
        for unroll in (2, 4, T, T + 3):
            got = rollout_rows(fr, x0, us, 0.01, (1,), unroll=unroll)
            for i in range(4):
                np.testing.assert_array_equal(
                    np.asarray(got[i]), np.asarray(ref[i])
                )

    def test_unroll_equivalence_jac(self):
        from cartpole_tpu.models.base import SINGLE_CARTPOLE
        from cartpole_tpu.ops.lanes import segment_rollout_with_jac_scan

        dp = default_single_params(jnp.float64)
        rng = np.random.RandomState(8)
        M, T = 17, 5
        x0 = tuple(jnp.asarray(rng.uniform(-1, 1, M)) for _ in range(4))
        us = jnp.asarray(rng.uniform(-5, 5, (T, M)))
        fj = lambda xr, u_: SINGLE_CARTPOLE.dynamics_jac_core(dp, xr, u_)

        xe1, Jx1, Ju1 = segment_rollout_with_jac_scan(
            fj, x0, us, 0.01, (1,), unroll=1
        )
        xeT, JxT, JuT = segment_rollout_with_jac_scan(
            fj, x0, us, 0.01, (1,), unroll=T
        )
        for a, b in zip(xe1, xeT):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(
            np.asarray(Jx1), np.asarray(JxT), rtol=1e-14, atol=1e-15
        )
        np.testing.assert_allclose(
            np.asarray(Ju1), np.asarray(JuT), rtol=1e-14, atol=1e-15
        )


class TestCondensedGuards:
    def test_zero_u_weights_rejected_at_build(self):
        """Both u weights zero -> the condensed core is singular and a
        failed step is terminal (QP_INDEFINITE); reject at build time."""
        import pytest

        from cartpole_tpu import OptimizationParams, default_single_params, make_mpc
        from cartpole_tpu.mpc.lanes import step_lanes
        from cartpole_tpu.mpc.controller import MPCState

        params = OptimizationParams(
            max_iterations=2, u_cost_weight=0.0,
            u_derivative_cost_weight=0.0, kkt_method="condensed",
        )
        mpc = make_mpc(params)
        dp = default_single_params(jnp.float64)
        x = jnp.zeros((4, 2), jnp.float64)
        st = MPCState(
            previous_solution=jnp.zeros((2, mpc.spec.dim), jnp.float64),
            warm=jnp.zeros((2,), bool),
        )
        with pytest.raises(ValueError, match="u-cost Gram"):
            step_lanes(mpc, st, x.T, dp, 0.0)

        x1 = jnp.zeros((4,), jnp.float64)
        st1 = mpc.init_state(jnp.float64)
        with pytest.raises(ValueError, match="u-cost Gram"):
            mpc.step(st1, x1, dp, 0.0)
