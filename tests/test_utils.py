"""Tests for tracing, structured logging, and checkpointing."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpole_tpu import (
    OptimizationParams,
    default_single_params,
    make_mpc,
)
from cartpole_tpu.utils import (
    SolveLog,
    TraceCollector,
    get_trace_json,
    is_tracing_enabled,
    load_state,
    save_state,
    set_tracing_enabled,
    solve_log_entry,
    solver_summary,
    trace_scope,
)

DOWN = np.array([0.0, -np.pi / 2, 0.0, 0.0])


def _one_solve():
    mpc = make_mpc(OptimizationParams(max_iterations=4))
    dp = default_single_params(jnp.float64)
    outputs, state = jax.jit(lambda s, x: mpc.step(s, x, dp))(
        mpc.init_state(jnp.float64), jnp.asarray(DOWN)
    )
    return mpc, outputs, state


class TestTracing:
    def test_scope_records_chrome_trace_event(self):
        set_tracing_enabled(True)
        try:
            TraceCollector.get_instance().clear()
            with trace_scope("solve", batch=4):
                pass
            doc = json.loads(get_trace_json())
            events = doc["traceEvents"]
            assert len(events) == 1
            ev = events[0]
            assert ev["name"] == "solve"
            assert ev["ph"] == "X"
            assert ev["args"] == {"batch": 4}
            assert "ts" in ev and "dur" in ev
        finally:
            set_tracing_enabled(False)

    def test_disabled_is_noop(self):
        assert not is_tracing_enabled()
        TraceCollector.get_instance().clear()
        with trace_scope("ignored"):
            pass
        assert get_trace_json() == ""
        assert (
            json.loads(TraceCollector.get_instance().get_trace_json())[
                "traceEvents"
            ]
            == []
        )


class TestSolveLog:
    def test_entry_has_reference_json_shape(self):
        """Field names mirror the reference serializer (wasm.cc:57-64,19)."""
        _, outputs, _ = _one_solve()
        entry = solve_log_entry(outputs)
        assert set(entry) == {
            "initial_state",
            "previous_solution",
            "solver_outputs",
            "u",
            "predicted_states",
        }
        assert set(entry["initial_state"]) == {"b_x", "th_1", "th_1_dot", "b_x_dot"}
        assert entry["initial_state"]["th_1"] == -np.pi / 2
        assert len(entry["u"]) == 40
        assert len(entry["predicted_states"]) == 40
        so = entry["solver_outputs"]
        assert so["termination_state"] in (
            "MAX_ITERATIONS",
            "SATISFIED_RELATIVE_TOL",
            "SATISFIED_FIRST_ORDER_TOL",
        )
        json.dumps(entry)  # round-trippable

    def test_non_finite_values_serialize_as_null(self):
        """A failed solve legitimately carries NaN/inf scalars; json.dumps
        would emit literal NaN/Infinity tokens that RFC parsers (JSON.parse,
        the reference log consumer) reject — they must become null."""
        _, outputs, _ = _one_solve()
        bad = outputs._replace(
            u=outputs.u.at[0].set(jnp.nan),
            solver=outputs.solver._replace(
                cost=jnp.asarray(jnp.nan),
                first_order_norm=jnp.asarray(jnp.inf),
            ),
        )
        entry = solve_log_entry(bad)
        text = json.dumps(entry)
        assert "NaN" not in text and "Infinity" not in text
        assert entry["solver_outputs"]["cost"] is None
        assert entry["solver_outputs"]["first_order_norm"] is None
        assert entry["u"][0] is None and entry["u"][1] is not None
        json.loads(text)

    def test_ring_buffer_caps(self):
        _, outputs, _ = _one_solve()
        log = SolveLog(capacity=3)
        for _ in range(5):
            log.append(outputs)
        assert len(log) == 3

    def test_save_and_batched_extend(self, tmp_path):
        mpc = make_mpc(OptimizationParams(max_iterations=2))
        dp = default_single_params(jnp.float64)
        n = 3
        states = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(n))
        xs = jnp.tile(jnp.asarray(DOWN), (n, 1))
        outputs, _ = jax.jit(jax.vmap(mpc.step, in_axes=(0, 0, None, None)))(
            states, xs, dp, 0.0
        )
        log = SolveLog()
        log.extend_batched(outputs)
        assert len(log) == n
        path = tmp_path / "log.json"
        log.save(str(path))
        assert len(json.loads(path.read_text())) == n

    def test_solver_summary_human_readable(self):
        _, outputs, _ = _one_solve()
        text = solver_summary(outputs.solver)
        assert "termination" in text
        assert "iter  0" in text


class TestParamsJson:
    def test_dynamics_params_round_trip(self):
        """Same field-name surface the reference serializes (wasm.cc:19-28)."""
        import json

        from cartpole_tpu import SingleCartPoleParams

        p = SingleCartPoleParams(m_b=1.3, k_s=77.0)
        payload = p.to_json()
        data = json.loads(payload)
        assert set(data) == {
            "m_b", "m_1", "l_1", "g", "mu_b", "v_mu_b", "c_d_1", "x_s", "k_s"
        }
        q = SingleCartPoleParams.from_json(payload)
        assert q == p

    def test_optimization_params_round_trip(self):
        from cartpole_tpu import OptimizationParams

        p = OptimizationParams(window_length=60, state_spacing=5)
        assert OptimizationParams.from_json(p.to_json()) == p

    def test_optimization_params_rejects_bad_limits(self):
        """A negative clamp limit would flow into jnp.clip(z, -lim, lim)
        with min > max and silently pin every decision variable to the
        upper bound — reject at construction like the other typos.
        (Negative-means-equality applies only to the final cost weights.)"""
        import pytest

        from cartpole_tpu import OptimizationParams

        with pytest.raises(ValueError, match="u_limit"):
            OptimizationParams(u_limit=-300.0)
        with pytest.raises(ValueError, match="b_x_limit"):
            OptimizationParams(b_x_limit=0.0)
        with pytest.raises(ValueError, match="line_search"):
            OptimizationParams(max_line_search_iterations=0)


class TestCheckpoint:
    def test_mpc_state_round_trip(self, tmp_path):
        mpc, _, state = _one_solve()
        path = str(tmp_path / "state.npz")
        save_state(path, state)
        restored = load_state(path, mpc.init_state(jnp.float64))
        np.testing.assert_array_equal(
            np.asarray(restored.previous_solution),
            np.asarray(state.previous_solution),
        )
        assert bool(restored.warm) == bool(state.warm)

    def test_resume_produces_identical_solve(self, tmp_path):
        """Checkpoint/resume parity: a restored warm start yields the exact
        same next solve (the reference's SetPreviousSolution contract)."""
        mpc, _, state = _one_solve()
        dp = default_single_params(jnp.float64)
        x = jnp.asarray(DOWN)
        path = str(tmp_path / "state.npz")
        save_state(path, state)
        restored = load_state(path, mpc.init_state(jnp.float64))

        step = jax.jit(lambda s: mpc.step(s, x, dp))
        out_a, _ = step(state)
        out_b, _ = step(restored)
        np.testing.assert_array_equal(np.asarray(out_a.u), np.asarray(out_b.u))

    def test_batched_sweep_round_trip(self, tmp_path):
        mpc = make_mpc(OptimizationParams(max_iterations=2))
        n = 4
        states = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(n))
        path = str(tmp_path / "batch.npz")
        save_state(path, states)
        restored = load_state(path, states)
        np.testing.assert_array_equal(
            np.asarray(restored.previous_solution),
            np.asarray(states.previous_solution),
        )

    def test_missing_leaf_raises(self, tmp_path):
        mpc, _, state = _one_solve()
        path = str(tmp_path / "state.npz")
        save_state(path, {"only": np.zeros(3)})
        try:
            load_state(path, state)
        except KeyError:
            pass
        else:
            raise AssertionError("expected KeyError")


class TestOrbaxCheckpoint:
    """The sharded-sweep backend: sharded save/restore + async save."""

    @pytest.fixture(autouse=True)
    def _need_orbax(self):
        from conftest import require_or_skip

        require_or_skip("orbax.checkpoint")

    def test_round_trip_preserves_values_and_resume(self, tmp_path):
        from cartpole_tpu.utils import load_state_orbax, save_state_orbax

        mpc, _, state = _one_solve()
        dp = default_single_params(jnp.float64)
        x = jnp.asarray(DOWN)
        path = str(tmp_path / "ckpt")
        save_state_orbax(path, state)
        restored = load_state_orbax(path, mpc.init_state(jnp.float64))
        np.testing.assert_array_equal(
            np.asarray(restored.previous_solution),
            np.asarray(state.previous_solution),
        )
        step = jax.jit(lambda s: mpc.step(s, x, dp))
        out_a, _ = step(state)
        out_b, _ = step(restored)
        np.testing.assert_array_equal(np.asarray(out_a.u), np.asarray(out_b.u))

    def test_sharded_restore_lands_on_mesh(self, tmp_path):
        """Restore places leaves directly onto the sharding of ``like`` —
        the resume path for scenario-sharded sweeps."""
        from cartpole_tpu.parallel import make_scenario_mesh, shard_scenarios
        from cartpole_tpu.utils import load_state_orbax, save_state_orbax

        mesh = make_scenario_mesh()
        mpc = make_mpc(OptimizationParams(max_iterations=2))
        n = 2 * len(jax.devices())
        states = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(n))
        sharded = shard_scenarios(states, mesh)
        path = str(tmp_path / "sharded_ckpt")
        save_state_orbax(path, sharded)
        restored = load_state_orbax(path, sharded)
        assert restored.previous_solution.sharding == sharded.previous_solution.sharding
        np.testing.assert_array_equal(
            np.asarray(restored.previous_solution),
            np.asarray(sharded.previous_solution),
        )

    def test_async_save(self, tmp_path):
        from cartpole_tpu.utils import load_state_orbax, save_state_orbax

        mpc, _, state = _one_solve()
        path = str(tmp_path / "async_ckpt")
        ckptr = save_state_orbax(path, state, async_save=True)
        ckptr.wait_until_finished()
        ckptr.close()
        restored = load_state_orbax(path, mpc.init_state(jnp.float64))
        np.testing.assert_array_equal(
            np.asarray(restored.previous_solution),
            np.asarray(state.previous_solution),
        )


def test_checkpoint_extensionless_path_round_trips(tmp_path):
    from cartpole_tpu.utils import load_state, save_state

    tree = {"a": np.arange(6.0), "b": np.ones((2, 3))}
    path = str(tmp_path / "ckpt")  # no .npz: np.savez appends it
    save_state(path, tree)
    restored = load_state(path, tree)
    np.testing.assert_array_equal(restored["a"], tree["a"])
