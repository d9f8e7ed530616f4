"""Unit tests for the batched constrained NLS solver (ops/solver.py) on small
synthetic problems with known solutions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpole_tpu import NLSConfig, NLSProblem, NLSTerminationState, solve_nls


def _plain_retract(z, dz, alpha):
    return z + alpha * dz


def _make_problem(residual_fn, constraint_fn=None, retract=_plain_retract):
    def linearize(z):
        r = residual_fn(z)
        J = jax.jacfwd(residual_fn)(z)
        if constraint_fn is None:
            c, A = None, None
        else:
            c = constraint_fn(z)
            A = jax.jacfwd(constraint_fn)(z)
        return r, J, c, A

    def evaluate(z):
        c = None if constraint_fn is None else constraint_fn(z)
        return residual_fn(z), c

    return NLSProblem(linearize=linearize, evaluate=evaluate, retract=retract)


class TestUnconstrained:
    def test_linear_least_squares_one_step(self):
        """min ||Az - b||^2 converges in one GN iteration."""
        A = jnp.asarray(np.random.default_rng(0).normal(size=(6, 3)))
        b = jnp.asarray(np.random.default_rng(1).normal(size=(6,)))
        problem = _make_problem(lambda z: A @ z - b)
        z, out = solve_nls(problem, jnp.zeros(3), NLSConfig(max_iterations=5))
        z_expected = jnp.linalg.lstsq(A, b)[0]
        np.testing.assert_allclose(np.asarray(z), np.asarray(z_expected), atol=1e-10)
        assert int(out.termination_state) in (
            NLSTerminationState.SATISFIED_RELATIVE_TOL,
            NLSTerminationState.SATISFIED_FIRST_ORDER_TOL,
        )

    def test_rosenbrock_nls(self):
        """Rosenbrock in least-squares form: r = (1-z0, 10(z1-z0^2))."""
        res = lambda z: jnp.stack([1.0 - z[0], 10.0 * (z[1] - z[0] ** 2)])
        problem = _make_problem(res)
        z, out = solve_nls(
            problem,
            jnp.asarray([-1.2, 1.0]),
            NLSConfig(max_iterations=50, relative_exit_tol=1e-14),
        )
        np.testing.assert_allclose(np.asarray(z), [1.0, 1.0], atol=1e-8)
        assert float(out.cost) < 1e-16


class TestEqualityConstrained:
    def test_projection_onto_plane(self):
        """min ||z - a||^2 s.t. sum(z) = 1 has closed-form solution."""
        a = jnp.asarray([3.0, -1.0, 0.5])
        res = lambda z: z - a
        con = lambda z: jnp.asarray([jnp.sum(z) - 1.0])
        problem = _make_problem(res, con)
        z, out = solve_nls(problem, jnp.zeros(3), NLSConfig(max_iterations=10))
        # KKT: z = a - lam/2 * 1 with sum(z) = 1 -> lam adjusts the mean.
        z_expected = a - (jnp.sum(a) - 1.0) / 3.0
        np.testing.assert_allclose(np.asarray(z), np.asarray(z_expected), atol=1e-8)
        assert float(out.constraint_violation) < 1e-10

    def test_nonlinear_constraint(self):
        """min ||z||^2 s.t. z0^2 + z1^2 = 4, from a non-symmetric start:
        solution lies on the circle of radius 2."""
        res = lambda z: z
        con = lambda z: jnp.asarray([z[0] ** 2 + z[1] ** 2 - 4.0])
        problem = _make_problem(res, con)
        z, out = solve_nls(
            problem,
            jnp.asarray([3.0, 1.0]),
            NLSConfig(max_iterations=30, relative_exit_tol=1e-12),
        )
        np.testing.assert_allclose(float(jnp.linalg.norm(z)), 2.0, atol=1e-6)
        assert float(out.constraint_violation) < 1e-6
        assert int(out.termination_state) not in (
            NLSTerminationState.MAX_LAMBDA,
            NLSTerminationState.QP_INDEFINITE,
        )

    def test_retraction_clamps_are_respected(self):
        """A clamp retraction keeps iterates inside the box."""
        a = jnp.asarray([10.0, 10.0])
        res = lambda z: z - a

        def retract(z, dz, alpha):
            return jnp.clip(z + alpha * dz, -2.0, 2.0)

        problem = _make_problem(res, retract=retract)
        z, _ = solve_nls(problem, jnp.zeros(2), NLSConfig(max_iterations=10))
        np.testing.assert_allclose(np.asarray(z), [2.0, 2.0], atol=1e-10)


class TestBatchingAndDiagnostics:
    def test_vmap_matches_sequential(self):
        """vmapped solves must equal per-instance solves bitwise-ish (the
        batch axis is pure data parallelism)."""
        rng = np.random.default_rng(42)
        targets = jnp.asarray(rng.normal(size=(8, 3)))

        def solve_one(a):
            res = lambda z: z * z - a  # nonlinear, solution sqrt(|a|) pattern
            con = lambda z: jnp.asarray([jnp.sum(z) - 1.0])
            problem = _make_problem(res, con)
            return solve_nls(
                problem, jnp.full((3,), 0.7), NLSConfig(max_iterations=25)
            )

        z_batch, out_batch = jax.vmap(solve_one)(targets)
        for i in range(8):
            z_i, out_i = solve_one(targets[i])
            np.testing.assert_allclose(
                np.asarray(z_batch[i]), np.asarray(z_i), atol=1e-12
            )
            assert int(out_batch.termination_state[i]) == int(out_i.termination_state)

    def test_iteration_traces_shape_and_freeze(self):
        a = jnp.asarray([3.0, -1.0, 0.5])
        problem = _make_problem(lambda z: z - a, lambda z: jnp.asarray([jnp.sum(z) - 1.0]))
        cfg = NLSConfig(max_iterations=9)
        _, out = solve_nls(problem, jnp.zeros(3), cfg)
        assert out.iter_cost.shape == (9,)
        n = int(out.n_iterations)
        assert 0 < n <= 9
        # Frozen iterations record NaN cost.
        assert bool(jnp.all(jnp.isnan(out.iter_cost[n:])))

    def test_jit_compatible(self):
        a = jnp.asarray([3.0, -1.0, 0.5])

        @jax.jit
        def run(a_):
            problem = _make_problem(
                lambda z: z - a_, lambda z: jnp.asarray([jnp.sum(z) - 1.0])
            )
            return solve_nls(problem, jnp.zeros(3), NLSConfig(max_iterations=10))

        z, _ = run(a)
        z_expected = a - (jnp.sum(a) - 1.0) / 3.0
        np.testing.assert_allclose(np.asarray(z), np.asarray(z_expected), atol=1e-8)


class TestKKTPadding:
    """The KKT systems are solved at their own size, unpadded, whatever
    that size is (awkward odd sizes included)."""

    def test_unconstrained_awkward_dim_padded_solve_exact(self):
        """dim=83 (odd, not a multiple of any tile): the unconstrained
        branch solves the normal equations exactly."""
        dim = 83
        rng = np.random.default_rng(2)
        A = jnp.asarray(rng.normal(size=(dim + 7, dim)))
        b = jnp.asarray(rng.normal(size=(dim + 7,)))
        problem = _make_problem(lambda z: A @ z - b)
        z, out = solve_nls(
            problem, jnp.zeros(dim), NLSConfig(max_iterations=5)
        )
        z_expected = jnp.linalg.lstsq(A, b)[0]
        np.testing.assert_allclose(
            np.asarray(z), np.asarray(z_expected), atol=1e-9
        )
        assert bool(np.all(np.isfinite(np.asarray(z))))

    @pytest.mark.parametrize("total", [83, 84, 88, 96])
    def test_lu_kkt_matches_numpy_f64(self, total):
        """The reference-parity ``lu`` KKT solve at awkward and round
        system sizes agrees with a numpy f64 solve of the same block
        system."""
        from cartpole_tpu.ops.solver import kkt_solve_lu

        n_eq = 7
        dim = total - n_eq
        rng = np.random.default_rng(total)
        J = rng.normal(size=(dim + 5, dim))
        r = rng.normal(size=(dim + 5,))
        A = rng.normal(size=(n_eq, dim))
        c = rng.normal(size=(n_eq,))
        lam, reg = 1e-3, 1e-10
        dz, nu = jax.jit(kkt_solve_lu)(
            jnp.asarray(J), jnp.asarray(r), jnp.asarray(A), jnp.asarray(c),
            lam, reg,
        )
        kkt = np.block([[J.T @ J + lam * np.eye(dim), A.T],
                        [A, -reg * np.eye(n_eq)]])
        want = np.linalg.solve(kkt, np.concatenate([-J.T @ r, -c]))
        assert dz.shape == (dim,) and nu.shape == (n_eq,)
        np.testing.assert_allclose(np.asarray(dz), want[:dim], atol=1e-9)
        np.testing.assert_allclose(np.asarray(nu), want[dim:], atol=1e-9)
