"""Structured MPC problem builder: hybrid multiple-shooting transcription.

Capability parity with ``Optimization::BuildProblem``
(``/root/reference/optimization/optimization.cc:194-331``), re-designed for
XLA: where the reference registers per-residual C++ lambdas with sparse index
maps into a type-erased ``mini_opt::Problem``, here the whole problem is three
pure functions over the decision vector plus *precomputed static structure*:

* the cost Jacobian is **constant** (all cost residuals are linear in ``z``),
  built once as a numpy array at trace time;
* the constraint Jacobian is block-bidiagonal in the shooting states; the
  nonlinear defect blocks come from ``jax.jacfwd`` of the segment rollout
  (vmapped over segments — replacing the reference's sequential
  RK4-with-Jacobians chain rule, ``optimization.cc:110-155``), and are
  assembled by einsum against static selection masks (no scatters);
* ``make_condensed_step`` additionally exploits that structure to eliminate
  the defect+pin rows exactly (the ``kkt_method="condensed"`` fast path).

Decision vector layout matches the reference (``optimization.cc:24-37``)::

    z = [x(0), x(1), ..., x(N-1), u(0), ..., u(K-1)],  dim = N*sd + K

with states packed ``state_dim``-wide first and controls in the tail.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CartPoleModel
from ..ops.integrate import mod_pi, rollout, segment_rollout_with_jac
from .config import OptimizationParams

__all__ = ["TerminalSpec", "MPCProblemSpec"]


def _tiny_spd_solve(S, b):
    """Solve a tiny (static n <= ~6) SPD system by fully unrolled scalar
    Cholesky — avoids XLA's batched-LAPACK custom calls for matrices far
    below their efficient size range. ``S`` is ``(n, n)`` or ``(n, n, B)``
    (lanes layout), ``b`` ``(n,)`` / ``(n, B)``: every scalar op broadcasts
    over the trailing batch axis.

    NOTE: superseded on the condensed hot paths — the terminal Schur block
    is now solved via a 2-pass-MGS QR of the *stacked factor*
    (:func:`_qr_gram_factor`), which avoids forming the Gram matrix at all
    (forming it squares cond(T) into the f32 entries). This function is
    retained as a tested standalone utility: its scale-relative-ridge
    design is the documented fix for the round-1 ``n_failed`` bench defect
    and the regression seeds in ``tests/test_f32_robustness.py`` replay
    against it.

    Robustness: ``S`` here is always a Gram matrix (SPD in exact
    arithmetic), but at stiff iterates its entries are quadratic forms of
    long Jacobian-chain products spanning ~1e30 — an *absolute* jitter is
    relatively meaningless at that scale, and in f32 (eps 6e-8)
    cancellation can push a Cholesky pivot negative -> sqrt -> NaN -> the
    whole solve poisoned (the round-1 ``n_failed`` bench defect). Three
    guards make the factorization total and scale-honest: Jacobi
    equilibration to unit diagonal (rows of very different physical scale
    — e.g. soft terminal-cost rows next to hard equality rows in the
    augmented Schur complement — would otherwise see a trace-relative
    ridge that swamps the small rows), a scale-RELATIVE ridge on the
    equilibrated diagonal (LM-spirit damping that bounds the condition
    number the factorization sees), and a pivot floor at the ridge level
    so sqrt never sees a negative. All are ~eps-sized perturbations in
    the well-conditioned regime; in the pathological regime they turn
    NaN into a finite (heavily damped) step that the merit line search
    is free to reject."""
    n = S.shape[0]
    eps_rel = 1.0e-5 if S.dtype == jnp.float32 else 1.0e-13
    tiny = jnp.asarray(1.0e-30, S.dtype)
    # Jacobi equilibration: solve (D S D) y = D b, x = D y with
    # D = diag(S)^{-1/2}; the equilibrated matrix has unit diagonal, so
    # the relative ridge below is proportionate PER ROW.
    s = [1.0 / jnp.sqrt(jnp.maximum(S[i, i], tiny)) for i in range(n)]
    ridge = jnp.asarray(eps_rel, S.dtype)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = S[i, j] * (s[i] * s[j])
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(acc + ridge, ridge))
            else:
                L[i][j] = acc / L[j][j]
    y = [None] * n
    for i in range(n):
        acc = b[i] * s[i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return jnp.stack([x[i] * s[i] for i in range(n)])


def _mgs_qr(T):
    """2-pass modified-Gram-Schmidt QR of a tall-skinny static-width
    ``T`` — ``(m, n)`` or ``(m, n, B)`` (lanes layout, trailing batch).

    Returns ``(qs, R)``: ``qs`` a length-``n`` list of orthonormal
    columns (each ``(m,)`` or ``(m, B)``) and ``R`` an ``n x n``
    list-of-lists of per-instance scalars (upper triangular, ``R[i][j]``
    set for ``i <= j``). Two MGS passes restore orthogonality to ~eps
    ("twice is enough"); a relative floor on each pivot guards rank
    collapse. All loops are static-width Python (n <= 7), so this lowers
    to fused dot-products over the lane axis."""
    n = T.shape[1]
    eps_rel = 1.0e-6 if T.dtype == jnp.float32 else 1.0e-14
    cols = [T[:, i] for i in range(n)]
    R = [[None] * n for _ in range(n)]
    qs = []
    for j in range(n):
        v = cols[j]
        orig_norm = jnp.sqrt(jnp.sum(v * v, axis=0))
        rj = [jnp.zeros_like(orig_norm) for _ in range(j)]
        for _pass in range(2):
            for i in range(j):
                h = jnp.sum(qs[i] * v, axis=0)
                v = v - h * qs[i]
                rj[i] = rj[i] + h
        nrm = jnp.sqrt(jnp.sum(v * v, axis=0))
        nrm = jnp.maximum(nrm, eps_rel * orig_norm + jnp.asarray(
            1.0e-30, cols[0].dtype
        ))
        for i in range(j):
            R[i][j] = rj[i]
        R[j][j] = nrm
        qs.append(v / nrm)
    return qs, R


def _tri_rt_solve(R, b):
    """Solve ``R^T y = b`` (forward substitution) for upper-triangular
    ``R`` as produced by :func:`_mgs_qr`; ``b`` a length-``n`` stack
    (``(n,)``, ``(n, B)``, or a list)."""
    n = len(R)
    y = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - R[k][i] * y[k]
        y[i] = acc / R[i][i]
    return y


def _tri_r_solve(R, b):
    """Solve ``R x = b`` (back substitution) for upper-triangular ``R``
    as produced by :func:`_mgs_qr`."""
    n = len(R)
    x = [None] * n
    for i in reversed(range(n)):
        acc = b[i]
        for k in range(i + 1, n):
            acc = acc - R[i][k] * x[k]
        x[i] = acc / R[i][i]
    return x


def _qr_gram_factor(T):
    """Factor a tall-skinny static-width ``T`` — ``(m, n)`` or
    ``(m, n, B)`` (lanes layout, trailing batch) — and return
    ``solve(b)`` computing ``(T^T T)^{-1} b`` via the R factor of a
    2-pass MGS QR plus unrolled triangular substitutions.

    The point is NEVER forming the Gram matrix: a Cholesky of
    ``A C^{-1} A^T + D`` sees cond(Gram) = cond(T)^2 — measured ~1e7+
    (equilibrated) for the double pole's terminal rows across a
    60-sample window, i.e. O(1)-wrong f32 steps no matter how the solve
    is refined, because the f32 Gram ENTRIES already carry the damage.
    QR touches only ``T`` itself (cond ~ sqrt of that), and two MGS
    passes ("twice is enough") restore orthogonality to ~eps in f32, so
    the attainable step error drops from cond*eps ~ O(1) to
    sqrt(cond)*eps ~ 1e-4. Cost: ~n^2 fused dot-products over the lane
    axis, n <= 7 static.

    Columns of ``T`` are guaranteed independent by construction here
    (every terminal row contributes a ``sqrt(D_i) e_i`` tail row), but a
    relative floor on the pivot guards rank collapse anyway."""
    _qs, R = _mgs_qr(T)  # only the R factor enters the Gram solve

    def solve(b):
        return jnp.stack(_tri_r_solve(R, _tri_rt_solve(R, b)))

    return solve


@dataclasses.dataclass(frozen=True)
class TerminalSpec:
    """One terminal-state objective: cost row (weight >= 0) or equality row."""

    coord: int  #: state coordinate index at the terminal shooting state.
    target: float  #: static target (ignored when is_setpoint).
    weight: float  #: residual weight (1.0 for equality rows).
    is_angle: bool  #: wrap the difference with mod_pi.
    is_setpoint: bool  #: target is the dynamic b_x set-point argument.


class MPCProblemSpec:
    """Precomputed static structure of the multiple-shooting NLS problem.

    The dynamic problem data (current state, set-point, previous control,
    dynamics params) are arguments of the methods, so one spec serves every
    batched/sharded instance.
    """

    def __init__(self, params: OptimizationParams, model: CartPoleModel):
        self.params = params
        self.model = model
        sd = model.state_dim
        K = params.window_length
        spacing = params.state_spacing
        N = params.num_states

        self.state_dim = sd
        self.num_states = N
        self.window_length = K
        self.spacing = spacing
        self.u_start = N * sd
        self.dim = N * sd + K
        self.n_defect = (N - 1) * sd

        n_q = sd // 2
        # Terminal objective coordinates in reference order:
        # b_x, angle(s), b_x_dot, angle rate(s) (optimization.cc:236-267).
        coord_specs = [(0, 0.0, params.b_x_final_cost_weight, False, True)]
        for a in model.angle_indices:
            coord_specs.append((a, math.pi / 2, params.th_final_cost_weight, True, False))
        coord_specs.append((n_q, 0.0, params.b_x_dot_final_cost_weight, False, False))
        for a in model.angle_indices:
            coord_specs.append((a + n_q, 0.0, params.th_dot_final_cost_weight, False, False))

        # Zero-weight rows are dropped: a weight-0 quadratic cost is
        # identically zero in the reference too (optimization.cc:236-267),
        # and dropping it keeps the augmented KKT's 1/w^2 diagonal finite.
        self.terminal_costs: Tuple[TerminalSpec, ...] = tuple(
            TerminalSpec(c, t, w, ang, sp) for (c, t, w, ang, sp) in coord_specs if w > 0.0
        )
        # Negative weight => equality constraint with unit weight
        # (optimization.cc:236-267).
        self.terminal_eqs: Tuple[TerminalSpec, ...] = tuple(
            TerminalSpec(c, t, 1.0, ang, sp) for (c, t, w, ang, sp) in coord_specs if w < 0.0
        )

        self._build_static_structure()

    # ------------------------------------------------------------------ static
    def _x_off(self, s: int) -> int:
        return s * self.state_dim

    def _build_static_structure(self):
        p, sd, N, K = self.params, self.state_dim, self.num_states, self.window_length
        D, u0 = self.dim, self.u_start
        xN = self._x_off(N - 1)

        # Constant cost Jacobian (all cost residuals are linear in z).
        rows = []
        for spec in self.terminal_costs:
            row = np.zeros(D)
            row[xN + spec.coord] = spec.weight
            rows.append(row)
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            for k in range(K - 1):
                row = np.zeros(D)
                row[u0 + k] = w
                row[u0 + k + 1] = -w
                rows.append(row)
            row = np.zeros(D)  # continuity with previous iteration's u(0).
            row[u0] = w
            rows.append(row)
        if p.u_cost_weight > 0.0:
            for k in range(K):
                row = np.zeros(D)
                row[u0 + k] = p.u_cost_weight
                rows.append(row)
        self.n_res = len(rows)
        self._J_cost = np.stack(rows) if rows else np.zeros((0, D))

        # Constant Jacobian of the linear equality rows: initial-state pins
        # (optimization.cc:228-232) then terminal equalities.
        lin_rows = []
        for i in range(sd):
            row = np.zeros(D)
            row[i] = 1.0
            lin_rows.append(row)
        for spec in self.terminal_eqs:
            row = np.zeros(D)
            row[xN + spec.coord] = 1.0
            lin_rows.append(row)
        self._A_lin = np.stack(lin_rows)
        self.n_eq = self.n_defect + self._A_lin.shape[0]

        # Block-bidiagonal selection masks for defect-Jacobian assembly.
        self._sel_this = np.eye(N - 1, N)  # segment s -> state s
        self._sel_next = np.eye(N - 1, N, k=1)  # segment s -> state s+1

        # Static reduced-space (condensed) cost structure: every cost row is
        # linear in z, and only the terminal-cost rows touch the states, so
        # the u-only part of the cost Jacobian is a static matrix and the
        # terminal rows become weight * M_{N-1}[coord] after condensing.
        u_rows = []
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            for k in range(K - 1):
                row = np.zeros(K)
                row[k] = w
                row[k + 1] = -w
                u_rows.append(row)
            row = np.zeros(K)
            row[0] = w
            u_rows.append(row)
        if p.u_cost_weight > 0.0:
            for k in range(K):
                row = np.zeros(K)
                row[k] = p.u_cost_weight
                u_rows.append(row)
        self._J_cost_u = np.stack(u_rows) if u_rows else np.zeros((0, K))

        # Retraction masks (optimization.cc:309-329).
        angle_mask = np.zeros(D, bool)
        pos_mask = np.zeros(D, bool)
        u_mask = np.zeros(D, bool)
        for s in range(N):
            for a in self.model.angle_indices:
                angle_mask[self._x_off(s) + a] = True
            pos_mask[self._x_off(s)] = True
        u_mask[u0:] = True
        self._angle_mask = angle_mask
        self._pos_mask = pos_mask
        self._u_mask = u_mask

    # ------------------------------------------------------------------ pieces
    def _split(self, z):
        """z -> (states (N, sd), per-segment controls (N-1, spacing))."""
        xs = z[: self.u_start].reshape(self.num_states, self.state_dim)
        useg = z[self.u_start :].reshape(self.num_states - 1, self.spacing)
        return xs, useg

    def _segment_fn(self, dynamics_params):
        """x(s), u_seg -> state integrated over one shooting segment
        (the reference's per-constraint RK4 chain, optimization.cc:117-137)."""
        f = lambda x, u: self.model.dynamics(dynamics_params, x, u)

        def segment(x_s, u_seg):
            x_end, _ = rollout(
                f, x_s, u_seg, self.params.control_dt, self.model.angle_indices
            )
            return x_end

        return segment

    def _segment_jac_fn(self, dynamics_params):
        """Vmapped-over-segments ``(xs, usegs) -> ((Jx, Ju), x_end)``.

        With ``params.analytic_jacobians``, uses the machine-generated
        closed-form dynamics Jacobians chained through
        :func:`segment_rollout_with_jac`; default is ``jacfwd`` of the
        segment rollout (one shared primal for all tangents).
        """
        model = self.model
        if self.params.analytic_jacobians and model.dynamics_jac is not None:
            fj = lambda x, u: model.dynamics_jac(dynamics_params, x, u)

            def seg(x_s, u_seg):
                x_end, Jx, Ju = segment_rollout_with_jac(
                    fj, x_s, u_seg, self.params.control_dt,
                    model.angle_indices,
                )
                return (Jx, Ju), x_end

            return jax.vmap(seg)

        segment = self._segment_fn(dynamics_params)

        def seg_with_aux(x_s, u_seg):
            x_end = segment(x_s, u_seg)
            return x_end, x_end

        return jax.vmap(
            jax.jacfwd(seg_with_aux, argnums=(0, 1), has_aux=True)
        )

    def _wrap_defect(self, diff):
        """mod_pi the angle components of a (…, sd) state difference
        (optimization.cc:156-158)."""
        for a in self.model.angle_indices:
            diff = diff.at[..., a].set(mod_pi(diff[..., a]))
        return diff

    def cost_residuals(self, z, set_point, u_prev):
        """Weighted cost residual vector r(z) (least-squares form)."""
        dtype = z.dtype
        pieces = []
        xN = z[self._x_off(self.num_states - 1) : self.u_start]
        for spec in self.terminal_costs:
            target = set_point if spec.is_setpoint else jnp.asarray(spec.target, dtype)
            diff = xN[spec.coord] - target
            if spec.is_angle:
                diff = mod_pi(diff)
            pieces.append(jnp.reshape(spec.weight * diff, (1,)))
        u = z[self.u_start :]
        p = self.params
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            pieces.append(w * (u[:-1] - u[1:]))
            pieces.append(jnp.reshape(w * (u[0] - u_prev), (1,)))
        if p.u_cost_weight > 0.0:
            pieces.append(p.u_cost_weight * u)
        if not pieces:
            return jnp.zeros((0,), dtype)
        return jnp.concatenate(pieces)

    def _linear_eq_residuals(self, xs, x_current, set_point):
        dtype = xs.dtype
        pin = xs[0] - x_current
        pin = self._wrap_defect(pin)
        pieces = [pin]
        xN = xs[-1]
        for spec in self.terminal_eqs:
            target = set_point if spec.is_setpoint else jnp.asarray(spec.target, dtype)
            diff = xN[spec.coord] - target
            if spec.is_angle:
                diff = mod_pi(diff)
            pieces.append(jnp.reshape(diff, (1,)))
        return jnp.concatenate(pieces)

    def constraints(self, z, x_current, set_point, dynamics_params):
        """Equality constraint vector c(z) (defects, pins, terminal eqs)."""
        xs, useg = self._split(z)
        segment = self._segment_fn(dynamics_params)
        x_end = jax.vmap(segment)(xs[:-1], useg)
        defect = self._wrap_defect(x_end - xs[1:])
        lin = self._linear_eq_residuals(xs, x_current, set_point)
        return jnp.concatenate([defect.reshape(-1), lin])

    # ---------------------------------------------------------------- closures
    def make_problem_fns(self, x_current, set_point, u_prev, dynamics_params):
        """Build the (linearize, evaluate, retract) closures for one solve.

        The captured values may be batched tracers (closures are created
        inside the vmapped step), so one spec serves every instance.
        """
        p = self.params
        sd, N, spacing = self.state_dim, self.num_states, self.spacing
        seg_jac = self._segment_jac_fn(dynamics_params)

        def linearize(z):
            dtype = z.dtype
            xs, useg = self._split(z)
            (jx, ju), x_end = seg_jac(xs[:-1], useg)  # (N-1,sd,sd), (N-1,sd,spacing)
            defect = self._wrap_defect(x_end - xs[1:])

            # Assemble the block-bidiagonal state part:
            #   rows of segment s: +J_x at state s, -I at state s+1.
            sel_this = jnp.asarray(self._sel_this, dtype)
            sel_next = jnp.asarray(self._sel_next, dtype)
            eye_sd = jnp.eye(sd, dtype=dtype)
            a_x = jnp.einsum("sab,st->satb", jx, sel_this) - jnp.einsum(
                "ab,st->satb", eye_sd, sel_next
            )
            a_x = a_x.reshape((N - 1) * sd, N * sd)
            # Controls: block-diagonal over segments.
            eye_seg = jnp.eye(N - 1, dtype=dtype)
            a_u = jnp.einsum("sak,st->satk", ju, eye_seg).reshape(
                (N - 1) * sd, (N - 1) * spacing
            )
            a_dyn = jnp.concatenate([a_x, a_u], axis=1)

            A = jnp.concatenate([a_dyn, jnp.asarray(self._A_lin, dtype)], axis=0)
            c = jnp.concatenate(
                [defect.reshape(-1), self._linear_eq_residuals(xs, x_current, set_point)]
            )
            r = self.cost_residuals(z, set_point, u_prev)
            J = jnp.asarray(self._J_cost, dtype)
            return r, J, c, A

        def evaluate(z):
            r = self.cost_residuals(z, set_point, u_prev)
            c = self.constraints(z, x_current, set_point, dynamics_params)
            return r, c

        def retract(z, dz, alpha):
            z2 = z + alpha * dz
            z2 = jnp.where(jnp.asarray(self._angle_mask), mod_pi(z2), z2)
            z2 = jnp.where(
                jnp.asarray(self._pos_mask),
                jnp.clip(z2, -p.b_x_limit, p.b_x_limit),
                z2,
            )
            z2 = jnp.where(
                jnp.asarray(self._u_mask), jnp.clip(z2, -p.u_limit, p.u_limit), z2
            )
            return z2

        return linearize, evaluate, retract

    # ------------------------------------------------------------- condensed
    def make_condensed_step(self, x_current, set_point, u_prev, dynamics_params):
        """Structure-exploiting damped GN step (``kkt_method="condensed"``).

        Eliminates the block-bidiagonal defect + pin equality rows exactly:
        states are affine in the controls through the linearized shooting
        recursion, so the full (N*sd+K + n_eq)-dim KKT system collapses to a
        K-var problem with only the terminal rows left to eliminate. The
        factorized matrix C = Hu + lam I contains only the STATIC u-cost
        rows, hence is unconditionally SPD (>= u_cost_weight^2 * I) — a
        clean K x K (=40 at defaults) Cholesky even in f32 instead of
        115 x 115. Terminal rows (soft costs and hard equalities alike) are
        eliminated through one tiny augmented Schur complement whose
        diagonal carries 1/w^2 for cost rows — the weights are never
        squared into any factorized matrix, which is what keeps the
        soft-terminal-cost mode usable in f32 (folding w=150 rows into the
        normal equations gives cond ~ 1e7 and garbage f32 steps). Same
        linear system solution as the dense path, i.e. identical GN
        iterates up to rounding; only the LM damping metric differs
        (du-space instead of full-z — identical while lambda = 0, which is
        every accepted nominal iteration).

        This is the batched answer to the reference's sparse mini_opt KKT
        (SURVEY.md §7 hard part 5): exploit structure to shrink the dense
        factorization, rather than build a sparse solver.
        """
        p = self.params
        sd, N, sp, K = self.state_dim, self.num_states, self.spacing, self.window_length
        S = N - 1
        seg_jac = self._segment_jac_fn(dynamics_params)

        term_costs = self.terminal_costs
        term_eqs = self.terminal_eqs
        n_t = len(term_eqs)
        n_tc = len(term_costs)
        n_all = n_tc + n_t
        # Augmented-KKT statics: terminal-cost weights never enter the
        # reduced Hessian (see the solve below) — they appear only as the
        # 1/w^2 diagonal of the tiny Schur complement, next to the ~0
        # diagonal of the hard equality rows.
        _w_costs = np.asarray([ts.weight for ts in term_costs], np.float64)
        _D_diag = np.concatenate(
            [1.0 / _w_costs**2, np.full(n_t, 1.0e-12)]
        )
        if not np.any(self._J_cost_u):
            # C = Hu + lam I is only unconditionally SPD because the static
            # u-cost rows are nonzero; with both u weights at 0 the lam=0
            # solve is singular and a failed step is terminal
            # (QP_INDEFINITE), so reject the configuration at build time.
            raise ValueError(
                "kkt_method='condensed' requires a nonzero u-cost Gram: "
                "set u_cost_weight or u_derivative_cost_weight > 0, or "
                "use kkt_method='lu'/'schur'"
            )
        _Hu_static = np.asarray(self._J_cost_u).T @ np.asarray(
            self._J_cost_u
        )

        def condensed_step(z, lam):
            dtype = z.dtype
            xs, useg = self._split(z)
            (jx, ju), x_end = seg_jac(xs[:-1], useg)
            defect = self._wrap_defect(x_end - xs[1:])  # (S, sd)
            pin = self._wrap_defect(xs[0] - x_current)  # (sd,)

            # Forward sensitivity: dx_s = M_s du + m_s with
            #   m_0 = -pin, M_0 = 0;  M/m_{s+1} = jx_s M/m_s (+ ju_s, +defect).
            def fwd(carry, inp):
                M, m = carry
                jx_s, ju_s, d_s, s = inp
                M2 = jx_s @ M
                M2 = jax.lax.dynamic_update_slice(M2, ju_s, (0, s * sp))
                m2 = jx_s @ m + d_s
                return (M2, m2), None

            M0 = jnp.zeros((sd, K), dtype)
            m0 = -pin
            (M_N, m_N), _ = jax.lax.scan(
                fwd, (M0, m0), (jx, ju, defect, jnp.arange(S))
            )

            # Reduced residuals / Jacobian. Row order matches
            # cost_residuals: terminal costs, then the static u-only rows.
            r = self.cost_residuals(z, set_point, u_prev)
            term_J = jnp.stack(
                [spec.weight * M_N[spec.coord] for spec in term_costs]
            ) if term_costs else jnp.zeros((0, K), dtype)
            term_aff = jnp.asarray(
                [spec.weight for spec in term_costs], dtype
            ) * jnp.stack(
                [m_N[spec.coord] for spec in term_costs]
            ) if term_costs else jnp.zeros((0,), dtype)
            J_bar = jnp.concatenate(
                [term_J, jnp.asarray(self._J_cost_u, dtype)], axis=0
            )
            aff = jnp.concatenate(
                [term_aff, jnp.zeros((self._J_cost_u.shape[0],), dtype)]
            )
            # Unweighted linearized terminal-cost residuals (the augmented
            # form's b rows): b_i = diff_i + m_N[coord_i].
            U_costs = jnp.stack(
                [M_N[ts.coord] for ts in term_costs]
            ) if term_costs else jnp.zeros((0, K), dtype)
            b_costs = (
                r[:n_tc] / jnp.asarray(_w_costs, dtype)
                + jnp.stack([m_N[ts.coord] for ts in term_costs])
            ) if term_costs else jnp.zeros((0,), dtype)

            # Remaining constraints: terminal equalities through M.
            xN = xs[-1]
            if n_t:
                A_bar = jnp.stack([M_N[spec.coord] for spec in term_eqs])
                c_vals = []
                for spec in term_eqs:
                    target = (
                        set_point if spec.is_setpoint
                        else jnp.asarray(spec.target, dtype)
                    )
                    diff = xN[spec.coord] - target
                    if spec.is_angle:
                        diff = mod_pi(diff)
                    c_vals.append(diff)
                c_term = jnp.stack(c_vals)
                c_bar = c_term + jnp.stack(
                    [m_N[spec.coord] for spec in term_eqs]
                )
            else:
                A_bar = jnp.zeros((0, K), dtype)
                c_term = jnp.zeros((0,), dtype)
                c_bar = jnp.zeros((0,), dtype)

            R_eq = None
            if n_t and p.rebase_equalities:
                # Constraint-space re-basing (OptimizationParams.
                # rebase_equalities): A_bar^T = Q R, so the rows of Q^T
                # are orthonormal and {A du = -c} = {Q^T du = -R^{-T} c}.
                # Exact-arithmetic step unchanged; the equality block of
                # the Schur factor T below gets orthonormal columns by
                # construction instead of cond(A_bar).
                qs_eq, R_eq = _mgs_qr(A_bar.T)
                A_bar = jnp.stack(qs_eq)
                c_bar = jnp.stack(_tri_rt_solve(R_eq, c_bar))

            # Full constraint values at z (same layout as constraints()):
            # the condensing rollout already produced defect and pin, so the
            # solver needs no separate evaluate() per iteration.
            c_full = jnp.concatenate([defect.reshape(-1), pin, c_term])

            # Reduced damped-GN step via the AUGMENTED system. Folding the
            # terminal-cost rows into the normal equations would square
            # their weights into the matrix (cond ~ w^2 ||M||^2 /
            # u_cost_weight^2 ~ 1e7 at w=150 — fatal in f32: the soft-cost
            # mode produced garbage steps on the deployment dtype).
            # Instead every terminal row — soft cost or hard equality —
            # is eliminated through one tiny Schur complement of
            #   [C      A_all^T] [du ]   [-g_s ]        C = Hu + lam I
            #   [A_all  -D     ] [mu ] = [-b   ],       D = diag(1/w^2 | 0)
            # which reproduces (C + U^T W U) du = -(g_s + U^T W b) exactly
            # while the weights only ever appear as the benign 1/w^2
            # diagonal: conditioning stays at cond(C) * cond(S).
            C = jnp.asarray(_Hu_static, dtype) + lam * jnp.eye(K, dtype=dtype)
            g_s = jnp.asarray(self._J_cost_u, dtype).T @ r[n_tc:]
            A_all = jnp.concatenate([U_costs, A_bar], axis=0)
            b_all = jnp.concatenate([b_costs, c_bar])
            D_diag = jnp.asarray(_D_diag, dtype)
            L = jnp.linalg.cholesky(C)
            rhs = jnp.concatenate([A_all.T, g_s[:, None]], axis=1)
            sol = jax.scipy.linalg.cho_solve((L, True), rhs)
            CiAt, Cig = sol[:, :n_all], sol[:, n_all]
            if n_all:
                # Schur solve via the STACKED factor T = [L^{-1} A^T;
                # D^{1/2}]: T^T T = A C^{-1} A^T + D, but the Gram matrix
                # is never formed (see _qr_gram_factor — forming it
                # squares cond(T) into the f32 entries).
                G = jax.scipy.linalg.solve_triangular(
                    L, A_all.T, lower=True
                )
                T = jnp.concatenate(
                    [G, jnp.diag(jnp.sqrt(D_diag))], axis=0
                )
                schur_solve = _qr_gram_factor(T)
                mu = schur_solve(b_all - A_all @ Cig)
                du = -(Cig + CiAt @ mu)
                # One factor-reusing refinement step (recovers f32 digits).
                res_d = -g_s - (C @ du + A_all.T @ mu)
                res_c = -b_all - (A_all @ du - D_diag * mu)
                Ci_rd = jax.scipy.linalg.cho_solve((L, True), res_d[:, None])[
                    :, 0
                ]
                e_y = schur_solve(A_all @ Ci_rd - res_c)
                du = du + Ci_rd - CiAt @ e_y
                mu = mu + e_y
            else:
                mu = jnp.zeros((0,), dtype)
                du = -Cig
            nu_bar = mu[n_tc:]
            if R_eq is not None:
                # Back to the ORIGINAL equality multipliers: A^T nu =
                # (R^{-T} A)^T nu_tilde requires nu = R^{-1} nu_tilde, so
                # the merit-ramp / adjoint semantics below are unchanged.
                nu_bar = jnp.stack(_tri_r_solve(R_eq, nu_bar))

            # Expand: forward recursion for the state step.
            def expand(carry, inp):
                dx = carry
                jx_s, ju_s, d_s, s = inp
                du_s = jax.lax.dynamic_slice(du, (s * sp,), (sp,))
                dx2 = jx_s @ dx + ju_s @ du_s + d_s
                return dx2, dx
            dxN, dx_stack = jax.lax.scan(
                expand, m0, (jx, ju, defect, jnp.arange(S))
            )
            dx_all = jnp.concatenate([dx_stack, dxN[None]], axis=0)  # (N, sd)
            dz = jnp.concatenate([dx_all.reshape(-1), du])

            # Exact directional derivative (J^T r) . dz.
            jr_dz = jnp.vdot(r, J_bar @ du + aff).real.astype(dtype)

            # Eliminated multipliers (defects pi_s, pin sigma) by the
            # backward adjoint pass — the merit penalty must dominate ALL
            # equality multipliers, not just the terminal ones. The
            # terminal-cost rows' post-step gradient contribution
            # w^2 (U du + b) IS the augmented multiplier mu.
            gN = jnp.zeros((sd,), dtype)
            for i, spec in enumerate(term_costs):
                gN = gN.at[spec.coord].add(mu[i])
            for j, spec in enumerate(term_eqs):
                gN = gN.at[spec.coord].add(nu_bar[j])

            def bwd(pi, jx_s):
                pi_prev = jx_s.T @ pi
                return pi_prev, jnp.max(jnp.abs(pi))
            pi0, pi_norms = jax.lax.scan(bwd, gN, jx, reverse=True)
            sigma_inf = jnp.max(jnp.abs(pi0))
            nu_inf = jnp.maximum(
                jnp.max(jnp.abs(nu_bar)) if n_t else jnp.zeros((), dtype),
                jnp.maximum(jnp.max(pi_norms), sigma_inf),
            )

            # Unified first-order diagnostic: the inf-norm of the FULL-z
            # Lagrangian gradient ``J^T r + A^T nu`` at the current iterate
            # — the same quantity the lu/schur paths report
            # (ops/solver.py). The eliminated defect/pin multipliers are
            # chosen by the adjoint recursion seeded from the *pre-step*
            # residuals, which zeroes every state row exactly (that is what
            # exact elimination means), so the norm reduces to the control
            # rows: static u-cost gradient plus the per-segment ju^T pi
            # adjoint contributions.
            gN_pre = jnp.zeros((sd,), dtype)
            for i, spec in enumerate(term_costs):
                gN_pre = gN_pre.at[spec.coord].add(spec.weight * r[i])
            for j, spec in enumerate(term_eqs):
                gN_pre = gN_pre.at[spec.coord].add(nu_bar[j])

            def bwd_pre(pi, inp):
                jx_s, ju_s = inp
                return jx_s.T @ pi, ju_s.T @ pi
            _, gu_segs = jax.lax.scan(bwd_pre, gN_pre, (jx, ju), reverse=True)
            g_u_full = (
                jnp.asarray(self._J_cost_u, dtype).T @ r[n_tc:]
                + gu_segs.reshape(-1)
            )
            first_order = jnp.max(jnp.abs(g_u_full))
            ok = (
                jnp.all(jnp.isfinite(dz))
                & jnp.all(jnp.isfinite(mu))
                & jnp.all(jnp.isfinite(jnp.diagonal(L)))
            )
            return dz, nu_inf, first_order, jr_dz, ok, r, c_full

        return condensed_step
