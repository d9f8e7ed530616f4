"""Scenario-sharding tests on a simulated 8-device CPU mesh.

The multi-chip tier the reference lacks entirely (SURVEY.md §2 parallelism
audit); runs on ``--xla_force_host_platform_device_count=8`` per conftest.
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
from cartpole_tpu.parallel import (
    host_local_batch,
    make_scenario_mesh,
    make_sharded_closed_loop,
    make_sharded_step,
    reduce_diagnostics,
    scenario_sharding,
    shard_scenarios,
)

DOWN = np.array([0.0, -np.pi / 2, 0.0, 0.0])


def _batch_states(mpc, n, dtype=jnp.float64):
    return jax.vmap(lambda _: mpc.init_state(dtype))(jnp.arange(n))


class TestMesh:
    def test_mesh_covers_all_devices(self):
        mesh = make_scenario_mesh()
        assert mesh.devices.size == len(jax.devices()) == 8

    def test_shard_scenarios_distributes_leading_axis(self):
        mesh = make_scenario_mesh()
        x = jnp.zeros((16, 4))
        xs = shard_scenarios(x, mesh)
        assert xs.sharding == scenario_sharding(mesh)
        assert xs.addressable_shards[0].data.shape == (2, 4)

    def test_host_local_batch_divisibility(self):
        mesh = make_scenario_mesh()
        assert host_local_batch(32, mesh) == 4
        try:
            host_local_batch(30, mesh)
        except ValueError:
            pass
        else:
            raise AssertionError("expected ValueError")


class TestShardedStep:
    def test_matches_unsharded_vmap(self):
        """The sharded batched step is numerically identical to plain vmap —
        sharding is a layout decision, not a semantics change."""
        mpc = make_mpc(OptimizationParams(max_iterations=4))
        dp = default_single_params(jnp.float64)
        mesh = make_scenario_mesh()
        n = 16

        rng = np.random.RandomState(1)
        x0s = np.tile(DOWN, (n, 1)) + rng.uniform(-0.2, 0.2, (n, 4))
        x0s = jnp.asarray(x0s)
        set_points = jnp.zeros((n,), jnp.float64)
        states = _batch_states(mpc, n)

        step = make_sharded_step(mpc, mesh, donate_state=False)
        out_sh, new_sh, diag = jax.block_until_ready(
            step(
                shard_scenarios(states, mesh),
                shard_scenarios(x0s, mesh),
                dp,
                shard_scenarios(set_points, mesh),
            )
        )

        plain = jax.jit(jax.vmap(mpc.step, in_axes=(0, 0, None, 0)))
        out_ref, new_ref = plain(states, x0s, dp, set_points)

        np.testing.assert_allclose(
            np.asarray(out_sh.u), np.asarray(out_ref.u), atol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(new_sh.previous_solution),
            np.asarray(new_ref.previous_solution),
            atol=1e-10,
        )
        assert int(diag.n_instances) == n
        assert int(diag.n_failed) == 0
        assert int(np.asarray(diag.termination_counts).sum()) == n

    def test_warm_state_stays_sharded_across_ticks(self):
        """Receding-horizon warm starts carry on-device (SURVEY.md §7 hard
        part 6): the output state keeps the scenario sharding."""
        mpc = make_mpc(OptimizationParams(max_iterations=3))
        dp = default_single_params(jnp.float64)
        mesh = make_scenario_mesh()
        n = 8
        x0s = shard_scenarios(jnp.tile(jnp.asarray(DOWN), (n, 1)), mesh)
        sps = shard_scenarios(jnp.zeros((n,)), mesh)
        states = shard_scenarios(_batch_states(mpc, n), mesh)

        step = make_sharded_step(mpc, mesh, donate_state=False)
        for _ in range(3):
            _, states, _ = step(states, x0s, dp, sps)
        assert states.previous_solution.sharding == scenario_sharding(mesh)


class TestShardedClosedLoop:
    def test_sharded_swingup_converges(self):
        mpc = make_mpc(OptimizationParams(max_iterations=10, state_spacing=5))
        dp = default_single_params(jnp.float64)
        mesh = make_scenario_mesh()
        n = 8
        rng = np.random.RandomState(2)
        x0s = np.tile(DOWN, (n, 1))
        x0s[:, 1] += rng.uniform(-0.2, 0.2, n)
        x0s = shard_scenarios(jnp.asarray(x0s), mesh)
        sps = shard_scenarios(jnp.zeros((n,)), mesh)

        num_steps = 200
        run = make_sharded_closed_loop(mpc, mesh, num_steps=num_steps)
        result, diag = jax.block_until_ready(run(x0s, dp, sps))

        xf = np.asarray(result.final_state)
        assert np.all(np.abs(xf[:, 1] - np.pi / 2) < 1e-3)
        assert int(diag.n_failed) == 0
        assert int(diag.n_instances) == n
        assert int(np.asarray(diag.termination_counts).sum()) == n * num_steps

    def test_matches_local_run(self):
        mpc = make_mpc(OptimizationParams(max_iterations=4))
        dp = default_single_params(jnp.float64)
        mesh = make_scenario_mesh()
        n = 8
        x0s = jnp.tile(jnp.asarray(DOWN), (n, 1))
        run = make_sharded_closed_loop(mpc, mesh, num_steps=5)
        result, _ = run(
            shard_scenarios(x0s, mesh),
            dp,
            shard_scenarios(jnp.zeros((n,)), mesh),
        )
        ref = jax.jit(lambda x0: run_closed_loop(mpc, x0, dp, 5))(x0s[0])
        np.testing.assert_allclose(
            np.asarray(result.controls)[0], np.asarray(ref.controls), atol=1e-8
        )


class TestBatchedParams:
    def test_parameter_grid_sweep_matches_single(self):
        """Per-scenario plant physics (the BASELINE 'scenarios x (mass,
        length) grid' config): each instance solves its own system and
        matches the corresponding single-system run."""
        import dataclasses

        mpc = make_mpc(OptimizationParams(max_iterations=4))
        mesh = make_scenario_mesh()
        n = 8
        masses = np.linspace(0.08, 0.15, n)
        lengths = np.linspace(0.2, 0.35, n)
        base = default_single_params(jnp.float64)
        grid = dataclasses.replace(
            jax.tree.map(lambda v: jnp.broadcast_to(v, (n,)), base),
            m_1=jnp.asarray(masses),
            l_1=jnp.asarray(lengths),
        )

        x0s = jnp.tile(jnp.asarray(DOWN), (n, 1))
        run = make_sharded_closed_loop(
            mpc, mesh, num_steps=5, batched_params=True
        )
        result, diag = jax.block_until_ready(
            run(
                shard_scenarios(x0s, mesh),
                shard_scenarios(grid, mesh),
                shard_scenarios(jnp.zeros((n,)), mesh),
            )
        )
        assert int(diag.n_failed) == 0

        from cartpole_tpu import run_closed_loop as rcl

        for i in (0, n - 1):
            single = dataclasses.replace(
                base,
                m_1=jnp.asarray(masses[i]),
                l_1=jnp.asarray(lengths[i]),
            )
            ref = jax.jit(lambda x: rcl(mpc, x, single, 5))(x0s[i])
            np.testing.assert_allclose(
                np.asarray(result.controls)[i],
                np.asarray(ref.controls),
                atol=1e-7,
            )
        # Different physics must give different controls.
        assert not np.allclose(
            np.asarray(result.controls)[0], np.asarray(result.controls)[-1]
        )


class TestShardedLanes:
    """shard_map composed with the batch-in-lanes condensed path
    (layout="lanes") — the scale-out pairing the GPU runs."""

    def _tiny_mpc(self):
        return make_mpc(OptimizationParams(
            window_length=4, state_spacing=2, max_iterations=2,
            max_line_search_iterations=2, kkt_method="condensed",
        ))

    def test_sharded_lanes_matches_unsharded_lanes(self):
        """Sharded lanes closed loop == unsharded lanes closed loop, with
        PER-INSTANCE dynamics params (the BASELINE grid-sweep shape)."""
        import dataclasses

        from cartpole_tpu.mpc.lanes import run_closed_loop_lanes

        mpc = self._tiny_mpc()
        mesh = make_scenario_mesh()
        n = 8
        base = default_single_params(jnp.float64)
        grid = dataclasses.replace(
            jax.tree.map(lambda v: jnp.broadcast_to(v, (n,)), base),
            m_1=jnp.asarray(np.linspace(0.08, 0.15, n)),
            l_1=jnp.asarray(np.linspace(0.2, 0.35, n)),
        )
        rng = np.random.RandomState(5)
        x0s = np.tile(DOWN, (n, 1))
        x0s[:, 1] += rng.uniform(-0.2, 0.2, n)
        x0s = jnp.asarray(x0s)
        sps = jnp.zeros((n,))

        run = make_sharded_closed_loop(
            mpc, mesh, num_steps=2, batched_params=True, layout="lanes",
        )
        result, diag = jax.block_until_ready(run(
            shard_scenarios(x0s, mesh),
            shard_scenarios(grid, mesh),
            shard_scenarios(sps, mesh),
        ))
        assert int(diag.n_instances) == n

        ref = run_closed_loop_lanes(mpc, x0s, grid, 2, sps)
        np.testing.assert_allclose(
            np.asarray(result.controls), np.asarray(ref.controls),
            atol=1e-8,
        )
        np.testing.assert_array_equal(
            np.asarray(result.termination_states),
            np.asarray(ref.termination_states),
        )
        np.testing.assert_allclose(
            np.asarray(result.final_state), np.asarray(ref.final_state),
            atol=1e-8,
        )

    def test_unknown_layout_rejected(self):
        mesh = make_scenario_mesh()
        for build in (make_sharded_step, make_sharded_closed_loop):
            kw = {"num_steps": 1} if build is make_sharded_closed_loop else {}
            try:
                build(self._tiny_mpc(), mesh, layout="lanes-tiled", **kw)
            except ValueError as e:
                assert "unknown layout" in str(e)
            else:
                raise AssertionError("expected ValueError")


class TestDiagnostics:
    def test_pmax_reduction_of_negative_f64_values(self):
        """Cross-device maxima go through ``lax.pmax``: the global max of
        all-negative f64 values over the 8-device mesh is exact (an
        all-reduce seeded with 0 would return 0)."""
        from jax.sharding import PartitionSpec as P

        from cartpole_tpu.ops.solver import NLSOutputs
        from cartpole_tpu.parallel.mesh import SCENARIO_AXIS

        mesh = make_scenario_mesh()
        n = 16
        rng = np.random.RandomState(4)
        viol = -rng.uniform(1.0, 2.0, n)
        first = -rng.uniform(3.0, 4.0, n)
        z = jnp.zeros((n,))
        solver = NLSOutputs(
            termination_state=jnp.zeros((n,), jnp.int32),
            n_iterations=jnp.ones((n,), jnp.int32),
            cost=z, constraint_violation=jnp.asarray(viol),
            first_order_norm=jnp.asarray(first), lambda_final=z,
            iter_cost=z, iter_violation=z, iter_lambda=z,
            iter_step_size=z, iter_first_order=z,
        )
        reduce = jax.jit(jax.shard_map(
            lambda s: reduce_diagnostics(s, SCENARIO_AXIS),
            mesh=mesh, in_specs=(P(SCENARIO_AXIS),), out_specs=P(),
            check_vma=False,
        ))
        diag = reduce(shard_scenarios(solver, mesh))
        assert float(diag.max_violation) == viol.max()
        assert float(diag.max_first_order) == first.max()
        assert int(diag.n_instances) == n

    def test_local_reduction_counts(self):
        mpc = make_mpc(OptimizationParams(max_iterations=4))
        dp = default_single_params(jnp.float64)
        n = 4
        x0s = jnp.tile(jnp.asarray(DOWN), (n, 1))
        states = _batch_states(mpc, n)
        outputs, _ = jax.jit(jax.vmap(mpc.step, in_axes=(0, 0, None, None)))(
            states, x0s, dp, 0.0
        )
        diag = reduce_diagnostics(outputs.solver)
        assert int(diag.n_instances) == n
        assert int(np.asarray(diag.termination_counts).sum()) == n
        assert float(diag.mean_iterations) > 0


class TestInitializeDistributed:
    def test_coordinator_address_env_is_forwarded(self, monkeypatch):
        """The COORDINATOR_ADDRESS spelling the opt-in gate accepts must be
        forwarded to jax.distributed.initialize, which itself only reads
        JAX_COORDINATOR_ADDRESS — otherwise the call falls into pod
        auto-detection and fails on ad-hoc clusters."""
        from cartpole_tpu.parallel import initialize_distributed

        seen = {}

        def fake_init(coordinator_address=None, num_processes=None,
                      process_id=None):
            seen.update(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )

        monkeypatch.setattr(jax.distributed, "initialize", fake_init)
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.setenv("COORDINATOR_ADDRESS", "coord:1234")
        initialize_distributed()
        assert seen["coordinator_address"] == "coord:1234"

    def test_no_opt_in_is_a_no_op(self, monkeypatch):
        from cartpole_tpu.parallel import initialize_distributed

        def boom(**kw):  # pragma: no cover - must not be called
            raise AssertionError("initialize called without opt-in")

        monkeypatch.setattr(jax.distributed, "initialize", boom)
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        initialize_distributed()
        initialize_distributed(num_processes=1)
