"""Drop-in ``pypendulum`` shim tests — cartpole_tpu/pypendulum.py.

Drives the exact nanobind surface of the reference's Python module
(``/root/reference/wrapper/wrapper.cc:40-103``) through the compat layer:
the ``model/scratch.py`` one-shot solve flow, the closed loop of
``optimization_test.cc:12-77`` written in reference style (stateful
``Optimization`` + ``Simulator`` objects), warm-start statefulness, and
the ``import pypendulum`` alias.
"""

import math
import sys

import numpy as np
import pytest

from cartpole_tpu import pypendulum


class TestScratchFlow:
    """The ``model/scratch.py:22-40`` flow, verbatim semantics."""

    def test_one_shot_solve(self):
        params = pypendulum.SingleCartPoleParams(
            1.0, 0.1, 0.25, 9.81, 0.05, 0.1, 0.02, 0.8, 100.0
        )
        x0_initial = pypendulum.SingleCartPoleState(0.0, 0.0, 0.0, 0.0)

        opt_params = pypendulum.OptimizationParams()
        opt_params.max_iterations = 30
        opt_params.state_spacing = 10
        opt_params.window_length = 40
        opt_params.absolute_first_derivative_tol = 1.0e-3
        opt_params.u_guess_sinusoid_amplitude = 10.0
        opt_params.u_cost_weight = 0.0
        opt_params.b_x_final_cost_weight = 5.0
        opt_params.th_final_cost_weight = -1.0
        opt_params.b_x_dot_final_cost_weight = 100.0
        opt_params.th_dot_final_cost_weight = 100.0
        opt = pypendulum.Optimization(opt_params)
        outputs = opt.step(x0_initial, params, 0.0)

        summary = outputs.solver_summary()
        assert "termination" in summary and "iter" in summary
        assert len(outputs.u) == 40
        assert len(outputs.predicted_states) == 40
        assert all(
            np.isfinite(
                [s.b_x, s.th_1, s.b_x_dot, s.th_1_dot]
            ).all()
            for s in outputs.predicted_states
        )
        # Terminal equality (negative theta weight): the planned window
        # ends upright.
        terminal = outputs.predicted_states[-1]
        assert terminal.th_1 == pytest.approx(math.pi / 2, abs=1e-4)

    def test_params_snapshot_at_construction(self):
        # The nanobind Optimization reads params once (optimization.cc:303);
        # mutating the python object afterwards must not affect it.
        opt_params = pypendulum.OptimizationParams()
        opt_params.max_iterations = 4
        opt = pypendulum.Optimization(opt_params)
        opt_params.max_iterations = 99
        assert opt._mpc.params.max_iterations == 4

    def test_defaults_to_reference_parity_kkt_path(self):
        # Drop-in users get the lu path (u(t) parity 2.8e-5 vs the oracle,
        # tests/test_native.py); the condensed fast path is an explicit opt-in.
        opt = pypendulum.Optimization(pypendulum.OptimizationParams())
        assert opt._mpc.params.kkt_method == "lu"
        fast = pypendulum.Optimization(
            pypendulum.OptimizationParams(), kkt_method="condensed"
        )
        assert fast._mpc.params.kkt_method == "condensed"

    def test_unknown_param_field_rejected(self):
        with pytest.raises(TypeError, match="unknown"):
            pypendulum.OptimizationParams(bogus=1.0)


class TestClosedLoop:
    """``optimization_test.cc:12-77`` written against the shim surface."""

    def test_swingup_reference_style(self):
        params = pypendulum.SingleCartPoleParams()
        opt_params = pypendulum.OptimizationParams()
        opt_params.state_spacing = 5
        opt_params.max_iterations = 10
        opt = pypendulum.Optimization(opt_params)
        sim = pypendulum.Simulator()

        # Simulator initializes hanging down (simulator.hpp:28).
        x = sim.get_state()
        assert x.th_1 == pytest.approx(-math.pi / 2)

        terminal_angles = []
        for t in range(150):
            state = sim.get_state()
            outputs = opt.step(state, params, 0.0)
            assert "MAX_LAMBDA" not in outputs.solver_summary().split("\n")[0]
            sim.step(params, opt_params.control_dt, outputs.u[0])
            if t > 100:
                terminal_angles.append(outputs.predicted_states[-1].th_1)

        # After warm-up every window plans to the upright equality.
        assert np.allclose(terminal_angles, math.pi / 2, atol=1e-4)
        xf = sim.get_state()
        assert abs(xf.th_1 - math.pi / 2) < 0.05
        assert abs(xf.th_1_dot) < 0.5

    def test_external_forces_via_vector2(self):
        params = pypendulum.SingleCartPoleParams()
        sim = pypendulum.Simulator()
        sim.step(params, 0.2, 0.0, f_base=pypendulum.Vector2(5.0, 0.0))
        assert sim.get_state().b_x_dot > 0.0  # pushed to +x

    def test_set_state_roundtrip(self):
        sim = pypendulum.Simulator()
        sim.set_state(pypendulum.SingleCartPoleState(0.3, 0.1, -0.2, 0.05))
        x = sim.get_state()
        assert (x.b_x, x.th_1, x.b_x_dot, x.th_1_dot) == pytest.approx(
            (0.3, 0.1, -0.2, 0.05)
        )


class TestWarmStartState:
    def test_step_carries_warm_start(self):
        params = pypendulum.SingleCartPoleParams()
        opt_params = pypendulum.OptimizationParams()
        opt_params.state_spacing = 10
        opt_params.max_iterations = 4
        x0 = pypendulum.SingleCartPoleState(0.0, -math.pi / 2, 0.0, 0.0)

        a = pypendulum.Optimization(opt_params)
        u1 = a.step(x0, params, 0.0).u
        u2_warm = a.step(x0, params, 0.0).u  # same x0, warm-started solve

        b = pypendulum.Optimization(opt_params)
        u1_b = b.step(x0, params, 0.0).u
        assert u1 == pytest.approx(u1_b)  # deterministic cold start
        assert not np.allclose(u1, u2_warm)  # warm start shifted the guess

    def test_reset_discards_warm_start(self):
        params = pypendulum.SingleCartPoleParams()
        opt_params = pypendulum.OptimizationParams()
        opt_params.state_spacing = 10
        opt_params.max_iterations = 4
        x0 = pypendulum.SingleCartPoleState(0.0, -math.pi / 2, 0.0, 0.0)
        opt = pypendulum.Optimization(opt_params)
        u_cold = opt.step(x0, params, 0.0).u
        opt.step(x0, params, 0.0)
        opt.reset()
        assert opt.step(x0, params, 0.0).u == pytest.approx(u_cold)

    def test_set_previous_solution(self):
        params = pypendulum.SingleCartPoleParams()
        opt_params = pypendulum.OptimizationParams()
        opt_params.state_spacing = 10
        opt_params.max_iterations = 4
        x0 = pypendulum.SingleCartPoleState(0.0, -math.pi / 2, 0.0, 0.0)

        a = pypendulum.Optimization(opt_params)
        first = a.step(x0, params, 0.0)
        second = a.step(x0, params, 0.0)

        # Seeding a fresh instance with a's first *solution* reproduces a's
        # second solve exactly: step() applies the same warm-start shift to
        # the stored vector either way (optimization.cc:50-57).
        b = pypendulum.Optimization(opt_params)
        b.set_previous_solution(np.asarray(first._outputs.solution))
        replay = b.step(x0, params, 0.0)
        assert replay.u == pytest.approx(second.u)

        with pytest.raises(ValueError, match="entries"):
            b.set_previous_solution([0.0, 1.0])


def test_import_pypendulum_alias():
    # After importing the shim, reference scripts' plain import works.
    assert "pypendulum" in sys.modules
    import pypendulum as pp

    assert pp.Optimization is pypendulum.Optimization
