"""Batched constrained nonlinear least-squares solver — the mini_opt replacement.

The reference delegates its inner loop to the external C++ ``mini_opt``
submodule (call surface documented in SURVEY.md §2): a constrained
Gauss-Newton with an inner KKT/QP solve, Levenberg-Marquardt damping
(``MAX_LAMBDA`` termination), a <=5-step line search, a ramped equality
penalty (``equality_penalty_initial``), and a caller-supplied retraction that
wraps angles and clamps decision variables
(``/root/reference/optimization/optimization.cc:73-81, 309-330``).

This module is a ground-up batched redesign of that capability:

* **One XLA program.** The solve is a fixed-trip ``lax.scan`` over iterations
  with per-instance convergence freezing — no data-dependent shapes or python
  control flow — so the entire solver jits, vmaps (thousands of independent
  MPC instances per chip) and shard_maps (scenario sharding across a mesh).
* **SQP-Gauss-Newton step.** Each iteration linearizes residuals ``r`` and
  equality constraints ``c`` and solves the damped KKT system::

      [ J^T J + lam*I   A^T ] [dz]   [-J^T r]
      [ A              -d*I ] [nu] = [-c    ]

  as one batched dense factorization — tiny per instance (~10^2 rows), huge in
  batch, which is exactly the shape XLA's batched linear algebra wants.
* **Globalization.** Backtracking line search on the exact L1 merit
  ``phi = 0.5||r||^2 + mu * ||c||_1`` with an Armijo test; all
  ``max_line_search_iterations`` candidates are evaluated in parallel and the
  first acceptable one selected by mask (a sequential search would serialize
  the batch). The penalty ``mu`` starts at ``equality_penalty_initial`` and
  ramps with the multiplier estimates. LM damping increases on rejection.
* **Diagnostics parity.** Returns an ``NLSOutputs`` PyTree with a termination
  state mirroring ``mini_opt::NLSTerminationState`` plus per-iteration
  cost/violation/lambda/step traces (the reference exposes these through
  ``NLSSolverOutputs``/tracing; here they are device arrays).

Problems are specified as three pure closures (see ``NLSProblem``); the MPC
layer provides structure-exploiting implementations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "NLSTerminationState",
    "NLSConfig",
    "NLSProblem",
    "NLSOutputs",
    "solve_nls",
    "termination_state_name",
]


class NLSTerminationState:
    """Integer termination codes (device-friendly analog of
    ``mini_opt::NLSTerminationState``; see ``optimization_test.cc:44-46``)."""

    MAX_ITERATIONS = 0
    SATISFIED_RELATIVE_TOL = 1
    SATISFIED_FIRST_ORDER_TOL = 2
    MAX_LAMBDA = 3
    QP_INDEFINITE = 4

    _NAMES = {
        0: "MAX_ITERATIONS",
        1: "SATISFIED_RELATIVE_TOL",
        2: "SATISFIED_FIRST_ORDER_TOL",
        3: "MAX_LAMBDA",
        4: "QP_INDEFINITE",
    }


def termination_state_name(code: int) -> str:
    return NLSTerminationState._NAMES.get(int(code), f"UNKNOWN({code})")


@dataclasses.dataclass(frozen=True)
class NLSConfig:
    """Static solver configuration (mirrors the param surface set at
    ``optimization.cc:73-79`` plus LM/merit knobs the submodule keeps
    internal)."""

    max_iterations: int = 8
    max_line_search_iterations: int = 5
    relative_exit_tol: float = 1.0e-5
    absolute_first_derivative_tol: float = 1.0e-6
    equality_penalty_initial: float = 1.0
    #: Growth factor applied to the merit penalty when multipliers grow.
    penalty_multiplier_margin: float = 2.0
    lambda_initial: float = 0.0
    lambda_increase: float = 10.0
    lambda_decrease: float = 0.5
    lambda_failure_floor: float = 1.0e-4
    lambda_max: float = 1.0e6
    armijo_c1: float = 1.0e-4
    #: Armijo slack in ulps of the merit value: accept steps whose merit
    #: is within ``merit_slack_ulps * eps(dtype) * |phi0|`` of the Armijo
    #: bound. Near a minimizer the true per-step improvement drops below
    #: the dtype's rounding noise (f32 at merit scale 1e4: noise ~6e-4),
    #: where a strict comparison rejects genuine steps, the LM lambda
    #: then ratchets x10 per "failure", and 10 consecutive noise-level
    #: rejections spuriously hit MAX_LAMBDA — measured as tens of
    #: thousands of false MAX_LAMBDA codes on the f32 double-pole bench
    #: at max_iterations >= 12. A few-ulp slack is invisible to the
    #: descent guarantee and converts those into clean terminations.
    merit_slack_ulps: float = 4.0
    #: Tiny negative regularization of the KKT constraint block.
    kkt_reg: float = 1.0e-10
    #: KKT linear-solver: "lu" factors the full symmetric-indefinite system
    #: (reference-parity path); "schur" eliminates through the regularized
    #: Gauss-Newton Hessian with two SPD Cholesky factorizations.
    kkt_method: str = "lu"
    #: Primal regularization floor added to the equilibrated augmented
    #: Hessian in the "schur" path (a dtype-aware floor of ~100 ulp also
    #: applies).
    schur_primal_reg: float = 1.0e-9
    #: Iterative-refinement steps on the "schur" KKT solve (factors are
    #: reused; recovers f32 accuracy).
    schur_refine: int = 1


@dataclasses.dataclass(frozen=True)
class NLSProblem:
    """A constrained NLS problem as pure closures over the decision vector
    ``z`` (shape ``(dim,)``).

    ``linearize(z) -> (r, J, c, A)``: residuals ``r`` (n_res,), Jacobian ``J``
    (n_res, dim), equality constraints ``c`` (n_eq,), constraint Jacobian ``A``
    (n_eq, dim). ``n_eq`` may be 0 for unconstrained problems.

    ``evaluate(z) -> (r, c)``: cheap re-evaluation for line search.

    ``retract(z, dz, alpha) -> z_new``: the manifold/clamp retraction
    (reference: mod-pi angles, clamp ``b_x`` and ``u``; ``optimization.cc:309-329``).

    ``condensed_step`` (optional): structure-exploiting replacement for the
    dense linearize+KKT step: ``(z, lam) -> (dz, nu_inf, first_order,
    jr_dz, ok, r, c)`` where ``dz`` is the damped Gauss-Newton step
    (satisfying the linearized constraints), ``nu_inf`` the inf-norm of ALL
    equality multipliers (for the merit penalty ramp), ``first_order`` the
    full-z Lagrangian-gradient inf-norm ``||J^T r + A^T nu||_inf`` (same
    semantics as the dense paths below — the condensed implementation
    recovers the eliminated multipliers by an adjoint pass so the state
    rows vanish exactly), ``jr_dz`` the exact directional
    derivative ``(J^T r) . dz``, ``ok`` a finite/solvable flag, and
    ``(r, c)`` the residual/constraint values at ``z`` (the condensing
    rollout already computes them — returning them avoids a second segment
    rollout per iteration). The solver's globalization (merit line search,
    LM damping, termination) is shared between the dense and condensed
    paths.
    """

    linearize: Callable[[Any], Any]
    evaluate: Callable[[Any], Any]
    retract: Callable[[Any, Any, Any], Any]
    condensed_step: Any = None


class NLSOutputs(NamedTuple):
    """Solver diagnostics PyTree (the ``NLSSolverOutputs`` analog)."""

    termination_state: Any  #: int32 code, see NLSTerminationState.
    n_iterations: Any  #: iterations actually applied (int32).
    cost: Any  #: final 0.5*||r||^2.
    constraint_violation: Any  #: final ||c||_inf.
    first_order_norm: Any  #: final ||J^T r + A^T nu||_inf.
    lambda_final: Any  #: final LM damping.
    #: Per-iteration traces, each shape (max_iterations,):
    iter_cost: Any
    iter_violation: Any
    iter_lambda: Any
    iter_step_size: Any  #: accepted line-search alpha (0 if rejected).
    iter_first_order: Any


def _merit(cost, c_l1, mu):
    return cost + mu * c_l1


def kkt_solve_lu(J, r, A, c, lam, kkt_reg):
    """Damped Gauss-Newton step from the full symmetric-indefinite KKT
    system (reference parity): ``[[J^T J + lam I, A^T], [A, -kkt_reg I]]
    [dz; nu] = [-J^T r; -c]``. Returns ``(dz, nu)``."""
    dim, n_eq = J.shape[-1], A.shape[0]
    dtype = J.dtype
    g = J.T @ r
    H = J.T @ J + lam * jnp.eye(dim, dtype=dtype)
    reg = -kkt_reg * jnp.eye(n_eq, dtype=dtype)
    kkt = jnp.block([[H, A.T], [A, reg]])
    rhs = jnp.concatenate([-g, -c])
    sol = jnp.linalg.solve(kkt, rhs)
    return sol[:dim], sol[dim:]


def solve_nls(problem: NLSProblem, z0, config: NLSConfig) -> tuple[Any, NLSOutputs]:
    """Solve one constrained NLS instance. Pure; callers ``vmap`` for batching.

    Args:
      problem: closures defining the problem (may capture batched tracers).
      z0: initial guess, shape ``(dim,)``.
      config: static solver configuration.

    Returns:
      ``(z_final, NLSOutputs)``.
    """
    # Accelerator f32 matmuls may run at reduced precision by default
    # (TF32 on NVIDIA tensor cores); the normal equations / KKT
    # factorizations need true f32 accumulation or Cholesky loses
    # positive-definiteness and solves spuriously hit MAX_LAMBDA.
    with jax.default_matmul_precision("float32"):
        return _solve_nls_impl(problem, z0, config)


def _solve_nls_impl(problem: NLSProblem, z0, config: NLSConfig):
    dtype = jnp.asarray(z0).dtype
    dim = z0.shape[-1]

    # Shape probe only: evaluate is a plain rollout, far cheaper to trace
    # than linearize's jacfwd assembly (which the condensed path never
    # uses — tracing it here would just inflate the jaxpr for DCE).
    _, c0 = problem.evaluate(z0)
    n_eq = 0 if c0 is None else c0.shape[-1]
    has_eq = n_eq > 0

    ls_alphas = 0.5 ** jnp.arange(config.max_line_search_iterations, dtype=dtype)

    def _kkt_solve_schur(J, r, A, c, lam):
        """Augmented-Lagrangian Schur elimination: two SPD Cholesky solves.

        H = J^T J is singular at lambda = 0 (shooting states appear in no
        cost), so plain range-space elimination needs a 1/rho-conditioned
        inverse — hopeless in f32. Instead the exact-equivalent augmented
        system is solved: adding gamma*A^T A to H (and gamma*A^T c to g)
        leaves the KKT solution unchanged while making the Hessian PD with
        O(1) conditioning, because null(A) intersect null(J) = {0} for this
        problem (the -I defect blocks pin states; u appears in the control
        costs). Everything is Jacobi-equilibrated first so gamma = 1 is the
        right scale in any dtype.
        """
        g = J.T @ r
        H = J.T @ J

        # Variable equilibration: s ~ 1/sqrt(column magnitude).
        a_col = jnp.sum(A * A, axis=0)
        s = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(H) + a_col, 1e-8))
        Hs = (H * s[None, :]) * s[:, None]
        As = A * s[None, :]
        gs = g * s
        # Constraint-row equilibration.
        rrow = 1.0 / jnp.sqrt(jnp.maximum(jnp.sum(As * As, axis=1), 1e-8))
        As = As * rrow[:, None]
        cs = c * rrow

        rho = jnp.maximum(
            config.schur_primal_reg, 100.0 * jnp.finfo(dtype).eps
        )
        # gamma = 1 in the equilibrated metric; LM damping acts in the
        # ORIGINAL variable metric (lam*I -> lam*s^2).
        H_aug = Hs + As.T @ As + jnp.diag(lam * s * s + rho)
        g_aug = gs + As.T @ cs

        L = jnp.linalg.cholesky(H_aug)
        rhs_block = jnp.concatenate([As.T, g_aug[:, None]], axis=1)
        sol = jax.scipy.linalg.cho_solve((L, True), rhs_block)
        HiAt, Hig = sol[:, :n_eq], sol[:, n_eq]
        S = As @ HiAt + config.kkt_reg * jnp.eye(n_eq, dtype=dtype)
        Ls = jnp.linalg.cholesky(S)

        def solve_pair(b_d, b_c):
            """Solve H_aug x + As^T y = b_d ; As x = b_c (factors reused)."""
            Hib = jax.scipy.linalg.cho_solve((L, True), b_d[:, None])[:, 0]
            y = jax.scipy.linalg.cho_solve(
                (Ls, True), (As @ Hib - b_c)[:, None]
            )[:, 0]
            x = Hib - HiAt @ y
            return x, y

        d_hat, nu_s = solve_pair(-g_aug, -cs)
        # One step of iterative refinement: recovers the digits the f32
        # factorization loses (no-op at f64 accuracy).
        for _ in range(config.schur_refine):
            res_d = -g_aug - (H_aug @ d_hat + As.T @ nu_s)
            res_c = -cs - As @ d_hat
            e_x, e_y = solve_pair(res_d, res_c)
            d_hat = d_hat + e_x
            nu_s = nu_s + e_y

        dz = d_hat * s
        nu = nu_s * rrow
        return dz, nu

    if config.kkt_method not in ("lu", "schur", "condensed"):
        raise ValueError(
            f"unknown kkt_method {config.kkt_method!r}; "
            "expected 'lu', 'schur', or 'condensed'"
        )
    if config.kkt_method == "condensed" and problem.condensed_step is None:
        raise ValueError(
            "kkt_method='condensed' requires the problem to provide a "
            "condensed_step (the MPC layer builds one; generic NLSProblems "
            "should use 'lu' or 'schur')"
        )

    def kkt_solve(J, r, A, c, lam):
        """Damped Gauss-Newton KKT step. Returns (dz, nu, ok)."""
        if has_eq:
            if config.kkt_method == "schur":
                dz, nu = _kkt_solve_schur(J, r, A, c, lam)
            else:
                dz, nu = kkt_solve_lu(J, r, A, c, lam, config.kkt_reg)
        else:
            g = J.T @ r
            H = J.T @ J + lam * jnp.eye(dim, dtype=dtype)
            dz = jnp.linalg.solve(H, -g)
            nu = jnp.zeros((0,), dtype=dtype)
        ok = jnp.all(jnp.isfinite(dz)) & jnp.all(jnp.isfinite(nu))
        return dz, nu, ok

    def c_l1(c):
        return jnp.sum(jnp.abs(c)) if has_eq else jnp.zeros((), dtype)

    def c_inf(c):
        return jnp.max(jnp.abs(c)) if has_eq else jnp.zeros((), dtype)

    use_condensed = config.kkt_method == "condensed"

    def iteration(carry, _):
        z, lam, mu, merit_prev, done, term, fo_carry = carry

        if use_condensed:
            dz, nu_inf, first_order, jr_dz, qp_ok, r, c = (
                problem.condensed_step(z, lam)
            )
        else:
            r, J, c, A = problem.linearize(z)
            dz, nu, qp_ok = kkt_solve(J, r, A, c, lam)
            grad_lag = J.T @ r + (A.T @ nu if has_eq else 0.0)
            first_order = jnp.max(jnp.abs(grad_lag))
            nu_inf = jnp.max(jnp.abs(nu)) if has_eq else jnp.zeros((), dtype)
            jr_dz = jnp.vdot(J.T @ r, dz).real.astype(dtype)

        cost = 0.5 * jnp.vdot(r, r).real.astype(dtype)
        viol1 = c_l1(c)
        dz = jnp.where(qp_ok, dz, jnp.zeros_like(dz))

        # Exact-penalty merit: ramp mu with the multiplier estimates so the
        # GN direction stays a descent direction for the merit.
        mu_new = jnp.maximum(mu, config.penalty_multiplier_margin * nu_inf)
        phi0 = _merit(cost, viol1, mu_new)
        # Directional derivative bound: grad(phi) . dz <= (J^T r).dz - mu*||c||_1.
        dphi = jr_dz - mu_new * viol1

        # Parallel backtracking line search on the retracted iterates.
        def trial(alpha):
            z_a = problem.retract(z, dz, alpha)
            r_a, c_a = problem.evaluate(z_a)
            cost_a = 0.5 * jnp.vdot(r_a, r_a).real.astype(dtype)
            phi_a = _merit(cost_a, c_l1(c_a), mu_new)
            return z_a, phi_a

        z_trials, phi_trials = jax.vmap(trial)(ls_alphas)
        phi_trials = jnp.where(jnp.isfinite(phi_trials), phi_trials, jnp.inf)
        slack = (
            config.merit_slack_ulps * jnp.finfo(dtype).eps * jnp.abs(phi0)
        )
        accepts = (
            phi_trials <= phi0 + config.armijo_c1 * ls_alphas * dphi + slack
        )
        any_accept = jnp.any(accepts) & qp_ok
        # First acceptable alpha (largest step).
        first_idx = jnp.argmax(accepts)
        z_accepted = jax.tree.map(lambda t: t[first_idx], z_trials)
        alpha_used = jnp.where(any_accept, ls_alphas[first_idx], 0.0)
        phi_new = jnp.where(any_accept, phi_trials[first_idx], phi0)

        # LM damping update.
        lam_next = jnp.where(
            any_accept,
            lam * config.lambda_decrease,
            jnp.maximum(lam * config.lambda_increase, config.lambda_failure_floor),
        )

        z_next = jnp.where(any_accept, z_accepted, z)

        # Termination checks (evaluated on the *updated* iterate).
        # merit_prev is +inf on iteration 0; keep the inf out of the
        # division (inf/inf -> NaN would be benign under the comparison
        # below but trips NaN debugging / checkify) and force the "no
        # previous merit" answer explicitly.
        prev_ok = jnp.isfinite(merit_prev)
        mp = jnp.where(prev_ok, merit_prev, jnp.zeros((), dtype))
        rel_change = jnp.where(
            prev_ok,
            jnp.abs(mp - phi_new)
            / jnp.maximum(jnp.abs(mp), jnp.asarray(1.0e-30, dtype)),
            jnp.asarray(jnp.inf, dtype),
        )
        conv_rel = any_accept & (rel_change < config.relative_exit_tol)
        conv_first = first_order < config.absolute_first_derivative_tol
        fail_lambda = lam_next > config.lambda_max
        fail_qp = ~qp_ok

        new_term = jnp.where(
            conv_first,
            NLSTerminationState.SATISFIED_FIRST_ORDER_TOL,
            jnp.where(
                conv_rel,
                NLSTerminationState.SATISFIED_RELATIVE_TOL,
                jnp.where(
                    fail_qp,
                    NLSTerminationState.QP_INDEFINITE,
                    jnp.where(
                        fail_lambda,
                        NLSTerminationState.MAX_LAMBDA,
                        NLSTerminationState.MAX_ITERATIONS,
                    ),
                ),
            ),
        ).astype(jnp.int32)
        now_done = conv_rel | conv_first | fail_lambda | fail_qp

        # Freeze finished instances.
        z_out = jnp.where(done, z, z_next)
        lam_out = jnp.where(done, lam, lam_next)
        mu_out = jnp.where(done, mu, mu_new)
        merit_out = jnp.where(done, merit_prev, phi_new)
        term_out = jnp.where(done, term, new_term)
        fo_out = jnp.where(done, fo_carry, first_order)
        done_out = done | now_done

        trace = (
            jnp.where(done, jnp.nan, cost),
            jnp.where(done, jnp.nan, c_inf(c)),
            jnp.where(done, jnp.nan, lam),
            jnp.where(done, 0.0, alpha_used),
            jnp.where(done, jnp.nan, first_order),
            ~done,  # iteration applied?
        )
        return (
            (z_out, lam_out, mu_out, merit_out, done_out, term_out, fo_out),
            trace,
        )

    init = (
        jnp.asarray(z0, dtype),
        jnp.asarray(config.lambda_initial, dtype),
        jnp.asarray(config.equality_penalty_initial, dtype),
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(False),
        jnp.asarray(NLSTerminationState.MAX_ITERATIONS, jnp.int32),
        jnp.asarray(jnp.inf, dtype),
    )
    (z, lam, _, _, _, term, first_order), traces = jax.lax.scan(
        iteration, init, None, length=config.max_iterations
    )
    iter_cost, iter_viol, iter_lambda, iter_alpha, iter_first, applied = traces

    # Final cost/violation at the solution (one cheap residual evaluation;
    # the first-order norm is the last applied iteration's Lagrangian
    # gradient — re-linearizing just for a diagnostic cost ~11% of a solve).
    r, c = problem.evaluate(z)
    cost = 0.5 * jnp.vdot(r, r).real.astype(dtype)
    viol = c_inf(c)

    outputs = NLSOutputs(
        termination_state=term,
        n_iterations=jnp.sum(applied.astype(jnp.int32)),
        cost=cost,
        constraint_violation=viol,
        first_order_norm=first_order,
        lambda_final=lam,
        iter_cost=iter_cost,
        iter_violation=iter_viol,
        iter_lambda=iter_lambda,
        iter_step_size=iter_alpha,
        iter_first_order=iter_first,
    )
    return z, outputs
