"""Batch-in-lanes MPC step — the batch-last rewrite of the hot path.

Under ``vmap`` every per-instance intermediate is a tiny ``(4, 4)`` page
with the batch leading, which tiled device layouts pad and strided
accesses waste. This module re-implements the condensed Gauss-Newton MPC
step with the batch in the TRAILING (lane) axis — every intermediate is
``(sd, M)`` / ``(sd, sd, M)`` with thousands of instances contiguous along
``M`` — using the machine-generated closed-form dynamics Jacobians
(``models/_*_gen.py``) chained through the batch-last RK4 of
``ops/lanes.py``.

Semantics are identical to ``vmap(MPC.step)`` with
``kkt_method="condensed"`` + ``analytic_jacobians=True``: same problem
structure (``mpc/problem.py``), same globalization (exact-penalty merit,
parallel Armijo backtracking, LM damping, per-instance freeze — see
``ops/solver.py``), same diagnostics PyTree. Only the memory layout
differs; tests assert tick-for-tick equivalence in f64.

Reference capability: the hot loop of
``/root/reference/optimization/optimization.cc:110-155`` (residual +
Jacobian evaluation) and the mini_opt inner solve, batched over thousands
of independent MPC instances per chip.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import SINGLE_CARTPOLE
from ..ops.integrate import mod_pi
from ..ops.lanes import (
    bmv,
    rollout_lanes,
    rollout_rows,
    segment_rollout_with_jac_lanes,
    segment_rollout_with_jac_scan,
)
from ..ops.solver import NLSConfig, NLSOutputs, NLSTerminationState
from .closed_loop import ClosedLoopResult
from .controller import MPC, MPCOutputs, MPCState
from .problem import _mgs_qr, _qr_gram_factor, _tri_r_solve, _tri_rt_solve


__all__ = ["step_lanes", "run_closed_loop_lanes", "simulator_step_lanes"]


class _Z(NamedTuple):
    """Lanes-layout decision iterate: shooting states + controls."""

    xs: Any  #: (sd, N, B)
    u: Any  #: (K, B)


def _param_folder(dynamics_params, batch: int):
    """Return ``fold(reps)``: dynamics params broadcastable against a
    ``(..., reps * batch)`` folded lane axis. Scalar leaves pass through;
    per-instance ``(B,)`` leaves are tiled across the fold."""

    def fold(reps: int):
        if reps == 1:
            return dynamics_params

        def one(leaf):
            leaf = jnp.asarray(leaf)
            if leaf.ndim == 0:
                return leaf
            assert leaf.shape == (batch,), leaf.shape
            return jnp.broadcast_to(leaf, (reps, batch)).reshape(-1)

        return jax.tree.map(one, dynamics_params)

    return fold


def _wrap_rows(arr, angle_indices):
    """mod_pi the given leading-axis rows of ``arr`` (sd, ...)."""
    for a in angle_indices:
        arr = arr.at[a].set(mod_pi(arr[a]))
    return arr


def _fold_lanes(arr, reps: int, batch: int):
    """Trial-major lane fold (index ``a * batch + b``): broadcast the
    trailing instance axis to ``reps`` copies and flatten. THE single
    definition of the fold order — the tiled line-search problem and the
    per-iteration trial folding must agree on it, or trial merits get
    attributed to the wrong instances."""
    arr = jnp.asarray(arr)
    return jnp.broadcast_to(
        arr[..., None, :], arr.shape[:-1] + (reps, batch)
    ).reshape(arr.shape[:-1] + (reps * batch,))


class _LanesProblem:
    """Per-solve closures over the lanes iterate (the batch-last analog of
    ``MPCProblemSpec.make_problem_fns`` + ``make_condensed_step``)."""

    def __init__(self, spec, x_current, set_point, u_prev, dynamics_params):
        # x_current (sd, B); set_point, u_prev (B,).
        self.spec = spec
        self.x_current = x_current
        self.set_point = set_point
        self.u_prev = u_prev
        self.B = x_current.shape[1]
        self.dynamics_params = dynamics_params
        self.fold = _param_folder(dynamics_params, self.B)
        self.dtype = x_current.dtype
        p = spec.params
        sd, N, sp, K = (
            spec.state_dim, spec.num_states, spec.spacing, spec.window_length
        )
        self.sd, self.N, self.sp, self.K = sd, N, sp, K
        self.S = N - 1
        # Static u-only cost structure (precomputed once, numpy).
        self._Ju_cost = np.asarray(spec._J_cost_u)  # (n_u, K)
        self._Hu = self._Ju_cost.T @ self._Ju_cost  # (K, K)
        self.n_tc = len(spec.terminal_costs)
        self.n_t = len(spec.terminal_eqs)
        # Spectral KKT precomputation: the factorized core of the reduced
        # system is C = Hu + lam*I — ONLY the static u-cost Gram matrix.
        # With Hu = Q diag(e) Q^T computed once in f64 at trace time,
        # C^{-1} is a per-instance diagonal rescale between two static
        # (K, K) matmuls. Every terminal row — soft cost
        # or hard equality — is eliminated through one tiny augmented
        # Schur complement (see condensed_step): cost weights enter only
        # as its 1/w^2 diagonal, never squared into a factorized matrix
        # (that would cost cond ~ w^2 ||M||^2 and produced garbage f32
        # steps in the soft-terminal-cost mode). This removes the batched
        # Cholesky from the hot path entirely.
        if not np.any(self._Ju_cost):
            # Hu == 0 would make the lam=0 rescale produce infs, and a
            # failed step is TERMINAL (fail_qp -> QP_INDEFINITE, matching
            # mini_opt) — there is no LM retry. Reject the config up front.
            raise ValueError(
                "kkt_method='condensed' requires a nonzero u-cost Gram: "
                "set u_cost_weight or u_derivative_cost_weight > 0, or "
                "use kkt_method='lu'/'schur'"
            )
        e, Q = np.linalg.eigh(self._Hu.astype(np.float64))
        self._Hu_eigs = np.maximum(e, 0.0)
        self._Hu_Q = Q
        # Augmented-KKT statics: cost-row weights and the Schur diagonal.
        self._w_costs = np.asarray(
            [ts.weight for ts in spec.terminal_costs], np.float64
        )
        self._D_diag = np.concatenate(
            [1.0 / self._w_costs**2, np.full(self.n_t, 1.0e-12)]
        )

    def tiled(self, A: int) -> "_LanesProblem":
        """A copy whose instance axis is ``A`` stacked copies of this
        problem's (fold order ``a * B + b``) — used to evaluate all ``A``
        line-search trials in ONE folded rollout instead of ``A``
        sequential ones."""

        def rep(arr):
            return _fold_lanes(arr, A, self.B)

        dp_tiled = jax.tree.map(
            lambda v: rep(v) if jnp.asarray(v).ndim else v,
            self.dynamics_params,
        )
        return _LanesProblem(
            self.spec, rep(self.x_current), rep(self.set_point),
            rep(self.u_prev), dp_tiled,
        )

    # ------------------------------------------------------------ residuals
    def cost_residuals(self, Z: _Z):
        """(n_res, B) — row order matches ``MPCProblemSpec.cost_residuals``."""
        spec, p = self.spec, self.spec.params
        dtype = Z.u.dtype
        xN = Z.xs[:, -1, :]  # (sd, B)
        pieces = []
        for ts in spec.terminal_costs:
            target = (
                self.set_point if ts.is_setpoint
                else jnp.asarray(ts.target, dtype)
            )
            diff = xN[ts.coord] - target
            if ts.is_angle:
                diff = mod_pi(diff)
            pieces.append((ts.weight * diff)[None])
        u = Z.u
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            pieces.append(w * (u[:-1] - u[1:]))
            pieces.append((w * (u[0] - self.u_prev))[None])
        if p.u_cost_weight > 0.0:
            pieces.append(p.u_cost_weight * u)
        if not pieces:
            return jnp.zeros((0, self.B), dtype)
        return jnp.concatenate(pieces, axis=0)

    def _terminal_eq_residuals(self, Z: _Z):
        spec = self.spec
        dtype = Z.u.dtype
        xN = Z.xs[:, -1, :]
        vals = []
        for ts in spec.terminal_eqs:
            target = (
                self.set_point if ts.is_setpoint
                else jnp.asarray(ts.target, dtype)
            )
            diff = xN[ts.coord] - target
            if ts.is_angle:
                diff = mod_pi(diff)
            vals.append(diff)
        if not vals:
            return jnp.zeros((0, self.B), dtype)
        return jnp.stack(vals)

    # ------------------------------------------------------------- segments
    def _fold_segments(self, Z: _Z):
        """-> (x_start (sd, S*B), useg (sp, S*B))."""
        sd, S, sp, B = self.sd, self.S, self.sp, self.B
        x_start = Z.xs[:, :-1, :].reshape(sd, S * B)
        useg = Z.u.reshape(S, sp, B).transpose(1, 0, 2).reshape(sp, S * B)
        return x_start, useg

    def _fold_segment_rows(self, Z: _Z):
        """Rows (structure-of-arrays) fold: per-coordinate (S*B,) start
        states — no packed (sd, M) intermediate is ever built
        (``ops/lanes.py`` SoA notes)."""
        sd, S, sp, B = self.sd, self.S, self.sp, self.B
        x_rows = tuple(Z.xs[i, :-1, :].reshape(S * B) for i in range(sd))
        useg = Z.u.reshape(S, sp, B).transpose(1, 0, 2).reshape(sp, S * B)
        return x_rows, useg

    def _constraints(self, Z: _Z):
        """Full equality-constraint values, (n_eq, B); row order matches
        ``MPCProblemSpec.constraints`` (defects s-major, pins, terminal)."""
        spec = self.spec
        sd, S, B = self.sd, self.S, self.B
        model, p = spec.model, spec.params
        dp = self.fold(S)
        angle = model.angle_indices
        if model.dynamics_core is not None:
            x_rows, useg = self._fold_segment_rows(Z)
            fr = lambda xr, u_: model.dynamics_core(dp, xr, u_)
            # unroll=1 for the short (T=sp) segment rollouts; the default
            # unroll=4 is meant for the long window rollouts.
            xe_rows = rollout_rows(
                fr, x_rows, useg, p.control_dt, angle, unroll=1
            )
            defect_rows = []
            for i in range(sd):
                d = xe_rows[i].reshape(S, B) - Z.xs[i, 1:, :]
                defect_rows.append(mod_pi(d) if i in angle else d)
            # s-major packing (matches MPCProblemSpec.constraints order).
            defect = jnp.stack(
                [defect_rows[i][s] for s in range(S) for i in range(sd)]
            )
        else:
            x_start, useg = self._fold_segments(Z)
            f = lambda x_, u_: model.dynamics(dp, x_, u_)
            x_end = rollout_lanes(
                f, x_start, useg, p.control_dt, angle
            ).reshape(sd, S, B)
            defect = _wrap_rows(x_end - Z.xs[:, 1:, :], angle).transpose(
                1, 0, 2
            ).reshape(S * sd, B)
        pin = _wrap_rows(
            Z.xs[:, 0, :] - self.x_current, model.angle_indices
        )
        c_term = self._terminal_eq_residuals(Z)
        return jnp.concatenate([defect, pin, c_term], axis=0)

    def evaluate(self, Z: _Z):
        return self.cost_residuals(Z), self._constraints(Z)

    def retract(self, Z: _Z, dZ: _Z, alpha):
        """Clamp/wrap retraction (``optimization.cc:309-329``); ``alpha``
        is a scalar or per-instance ``(B,)``."""
        spec, p = self.spec, self.spec.params
        a = jnp.asarray(alpha, Z.u.dtype)
        xs = Z.xs + a * dZ.xs
        u = jnp.clip(Z.u + a * dZ.u, -p.u_limit, p.u_limit)
        xs = _wrap_rows(xs, spec.model.angle_indices)
        xs = xs.at[0].set(jnp.clip(xs[0], -p.b_x_limit, p.b_x_limit))
        return _Z(xs=xs, u=u)

    # ------------------------------------------------------------ condensed
    def condensed_step(self, Z: _Z, lam):
        """Batch-last condensed damped-GN step; same math as
        ``MPCProblemSpec.make_condensed_step`` (see there for the
        derivation), ``lam`` per-instance ``(B,)``.

        Returns ``(dZ, nu_inf, first_order, jr_dz, ok, r, c_full)`` with
        per-instance ``(B,)`` scalars.
        """
        spec = self.spec
        sd, S, sp, K, B = self.sd, self.S, self.sp, self.K, self.B
        model, p = spec.model, spec.params
        dtype = Z.u.dtype
        term_costs, term_eqs = spec.terminal_costs, spec.terminal_eqs
        n_tc, n_t = self.n_tc, self.n_t

        dp = self.fold(S)
        if model.dynamics_jac_core is not None:
            # Rows (SoA) linearization: the 20-odd sequential dynamics+
            # chain-rule evaluations run on per-coordinate (S*B,) arrays
            # (no packing / scatter) inside one scanned RK4 body
            # (compile-time control); results come back
            # packed for the tile-friendly (.., S, B) condensation.
            x_rows, useg = self._fold_segment_rows(Z)
            fjr = lambda xr, u_: model.dynamics_jac_core(dp, xr, u_)
            x_end, Jx, Ju = segment_rollout_with_jac_scan(
                fjr, x_rows, useg, p.control_dt, model.angle_indices
            )
            x_end = x_end.reshape(sd, S, B)
            Jx = Jx.reshape(sd, sd, S, B)
            Ju = Ju.reshape(sd, sp, S, B)
        else:
            x_start, useg = self._fold_segments(Z)
            fj = lambda x_, u_: model.dynamics_jac(dp, x_, u_)
            x_end, Jx, Ju = segment_rollout_with_jac_lanes(
                fj, x_start, useg, p.control_dt, model.angle_indices
            )
            x_end = x_end.reshape(sd, S, B)
            Jx = Jx.reshape(sd, sd, S, B)
            Ju = Ju.reshape(sd, sp, S, B)
        defect = _wrap_rows(x_end - Z.xs[:, 1:, :], model.angle_indices)
        pin = _wrap_rows(Z.xs[:, 0, :] - self.x_current, model.angle_indices)

        # Forward condensation: dx_s = M_s du + m_s (unrolled; S is small
        # and static, and unrolling keeps the Ju column updates static).
        M = jnp.zeros((sd, K, B), dtype)
        m = -pin
        for s in range(S):
            jx_s = Jx[:, :, s, :]
            M = jnp.sum(jx_s[:, :, None, :] * M[None, :, :, :], axis=1)
            M = M.at[:, s * sp:(s + 1) * sp, :].set(Ju[:, :, s, :])
            m = bmv(jx_s, m) + defect[:, s, :]

        r = self.cost_residuals(Z)
        r_term = r[:n_tc]
        r_u = r[n_tc:]
        if n_tc:
            term_J = jnp.stack(
                [ts.weight * M[ts.coord] for ts in term_costs]
            )  # (n_tc, K, B) — weighted rows, used for jr_dz below.
            term_aff = jnp.stack(
                [ts.weight * m[ts.coord] for ts in term_costs]
            )  # (n_tc, B)
            r_bar_term = r_term + term_aff
            # Unweighted rows/residuals for the augmented system.
            U_costs = jnp.stack([M[ts.coord] for ts in term_costs])
            b_costs = r_bar_term * jnp.asarray(
                1.0 / self._w_costs, dtype
            )[:, None]
        else:
            term_J = jnp.zeros((0, K, B), dtype)
            term_aff = jnp.zeros((0, B), dtype)
            r_bar_term = r_term
            U_costs = jnp.zeros((0, K, B), dtype)
            b_costs = jnp.zeros((0, B), dtype)

        g_s = jnp.asarray(self._Ju_cost.T, dtype) @ r_u  # (K, B)

        c_term = self._terminal_eq_residuals(Z)
        if n_t:
            A_eq = jnp.stack([M[ts.coord] for ts in term_eqs])  # (n_t,K,B)
            c_bar = c_term + jnp.stack([m[ts.coord] for ts in term_eqs])
        else:
            A_eq = jnp.zeros((0, K, B), dtype)
            c_bar = jnp.zeros((0, B), dtype)

        R_eq = None
        if n_t and p.rebase_equalities:
            # Constraint-space re-basing (OptimizationParams.
            # rebase_equalities; see MPCProblemSpec.make_condensed_step):
            # per-instance QR of A_eq^T makes the equality rows
            # orthonormal — same constraint set, same exact-arithmetic
            # step, but the equality block of the Schur factor T stops
            # carrying cond(A_eq) into the f32 solve.
            qs_eq, R_eq = _mgs_qr(jnp.transpose(A_eq, (1, 0, 2)))
            A_eq = jnp.stack(qs_eq)
            c_bar = jnp.stack(_tri_rt_solve(R_eq, c_bar))

        # Augmented KKT solve (see __init__): factorized core
        # C = Hu + lam I in the static eigenbasis; ALL terminal rows
        # (soft costs then hard equalities) eliminated via one tiny Schur
        # complement  S = A C^{-1} A^T + diag(1/w^2 | ~0)  — no
        # factorization on the device, only static (K, K) matmuls and
        # lane-wise elementwise work, and no w^2 conditioning anywhere.
        n_all = n_tc + n_t
        A_all = jnp.concatenate([U_costs, A_eq], axis=0)  # (n_all, K, B)
        b_all = jnp.concatenate([b_costs, c_bar], axis=0)  # (n_all, B)
        Q = jnp.asarray(self._Hu_Q, dtype)
        eigs = jnp.asarray(self._Hu_eigs, dtype)
        d_inv = 1.0 / (eigs[:, None] + lam[None, :])  # (K, B)

        def eig_rescale(diag):
            """Apply ``Q diag Q^T`` to stacked rows ``X (R, K, B)`` — the
            eigenbasis-diagonal form shared by ``C^{-1}`` (diag = d_inv)
            and ``C^{-1/2}`` (diag = sqrt(d_inv))."""

            def apply(X):
                R = X.shape[0]
                X2 = jnp.transpose(X, (1, 0, 2)).reshape(K, R * B)
                Y = (Q.T @ X2).reshape(K, R, B) * diag[:, None, :]
                Zr = (Q @ Y.reshape(K, R * B)).reshape(K, R, B)
                return jnp.transpose(Zr, (1, 0, 2))

            return apply

        c_solve = eig_rescale(d_inv)  # (Hu + lam I)^{-1} X

        def c_mul(x):
            """(Hu + lam I) x for x (K, B) — used by the refinement."""
            return Q @ ((Q.T @ x) * (eigs[:, None] + lam[None, :]))

        sol = c_solve(jnp.concatenate([A_all, g_s[None]], axis=0))
        CiA, Cig = sol[:n_all], sol[n_all]
        if n_all:
            D_vec = jnp.asarray(self._D_diag, dtype)
            # Schur solve via the STACKED factor T = [C^{-1/2} A^T;
            # D^{1/2}] — T^T T = A C^{-1} A^T + D, but the Gram matrix is
            # never formed (see problem._qr_gram_factor: forming it
            # squares cond(T) into the f32 entries; measured O(1)-wrong
            # double-pole steps). C^{-1/2} rides the same static
            # eigenbasis as c_solve.
            chalf_solve = eig_rescale(jnp.sqrt(d_inv))  # C^{-1/2} X
            G = chalf_solve(A_all)  # (n_all, K, B)
            T = jnp.concatenate([
                jnp.transpose(G, (1, 0, 2)),  # (K, n_all, B)
                jnp.broadcast_to(
                    jnp.asarray(np.diag(np.sqrt(self._D_diag)), dtype)[
                        :, :, None
                    ],
                    (n_all, n_all, B),
                ),
            ], axis=0)
            schur_solve = _qr_gram_factor(T)
            A_Cig = jnp.sum(A_all * Cig[None], axis=1)
            mu = schur_solve(b_all - A_Cig)  # (n_all, B)
            du = -(Cig + jnp.sum(CiA * mu[:, None, :], axis=0))
            # One refinement step on the augmented system (f32 digit
            # recovery; reuses the spectral basis and the QR factor).
            At_mu = jnp.sum(A_all * mu[:, None, :], axis=0)
            res_d = -g_s - (c_mul(du) + At_mu)
            res_c = -b_all - (
                jnp.sum(A_all * du[None], axis=1) - D_vec[:, None] * mu
            )
            Ci_rd = c_solve(res_d[None])[0]
            e_y = schur_solve(
                jnp.sum(A_all * Ci_rd[None], axis=1) - res_c
            )
            du = du + Ci_rd - jnp.sum(CiA * e_y[:, None, :], axis=0)
            mu = mu + e_y
        else:
            mu = jnp.zeros((0, B), dtype)
            du = -Cig
        mu_c, nu = mu[:n_tc], mu[n_tc:]
        if R_eq is not None:
            # Back to the ORIGINAL equality multipliers (nu = R^{-1}
            # nu_tilde): merit-ramp / adjoint semantics stay unchanged.
            nu = jnp.stack(_tri_r_solve(R_eq, nu))

        # Expand the state step by the forward recursion.
        dx = -pin
        dxs = [dx]
        for s in range(S):
            du_s = du[s * sp:(s + 1) * sp]  # (sp, B)
            dx = (
                bmv(Jx[:, :, s, :], dx)
                + jnp.sum(Ju[:, :, s, :] * du_s[None], axis=1)
                + defect[:, s, :]
            )
            dxs.append(dx)
        dZ = _Z(xs=jnp.stack(dxs, axis=1), u=du)

        # Exact directional derivative (J^T r) . dz.
        Jdu_term = jnp.sum(term_J * du[None], axis=1)  # (n_tc, B)
        Jdu_u = jnp.asarray(self._Ju_cost, dtype) @ du  # (n_u, B)
        jr_dz = jnp.sum(r_term * (Jdu_term + term_aff), axis=0) + jnp.sum(
            r_u * Jdu_u, axis=0
        )

        # Eliminated multipliers (post-step estimate) for the merit ramp.
        # The terminal-cost rows' post-step gradient w^2 (U du + b) IS the
        # augmented multiplier mu_c.
        gN = jnp.zeros((sd, B), dtype)
        for i, ts in enumerate(term_costs):
            gN = gN.at[ts.coord].add(mu_c[i])
        for j, ts in enumerate(term_eqs):
            gN = gN.at[ts.coord].add(nu[j])
        pi = gN
        pi_max = jnp.zeros((B,), dtype)
        for s in reversed(range(S)):
            pi_max = jnp.maximum(pi_max, jnp.max(jnp.abs(pi), axis=0))
            pi = jnp.sum(Jx[:, :, s, :] * pi[:, None, :], axis=0)
        sigma_inf = jnp.max(jnp.abs(pi), axis=0)
        nu_abs = (
            jnp.max(jnp.abs(nu), axis=0) if n_t else jnp.zeros((B,), dtype)
        )
        nu_inf = jnp.maximum(nu_abs, jnp.maximum(pi_max, sigma_inf))

        # Unified first-order diagnostic (see MPCProblemSpec.
        # make_condensed_step): full-z Lagrangian gradient inf-norm with
        # the eliminated multipliers from the PRE-step residuals.
        gN_pre = jnp.zeros((sd, B), dtype)
        for i, ts in enumerate(term_costs):
            gN_pre = gN_pre.at[ts.coord].add(ts.weight * r_term[i])
        for j, ts in enumerate(term_eqs):
            gN_pre = gN_pre.at[ts.coord].add(nu[j])
        pi = gN_pre
        gu = [None] * S
        for s in reversed(range(S)):
            gu[s] = jnp.sum(Ju[:, :, s, :] * pi[:, None, :], axis=0)
            pi = jnp.sum(Jx[:, :, s, :] * pi[:, None, :], axis=0)
        g_u_full = jnp.asarray(self._Ju_cost.T, dtype) @ r_u + jnp.concatenate(
            gu, axis=0
        )
        first_order = jnp.max(jnp.abs(g_u_full), axis=0)

        ok = (
            jnp.all(jnp.isfinite(dZ.xs), axis=(0, 1))
            & jnp.all(jnp.isfinite(du), axis=0)
            & (
                jnp.all(jnp.isfinite(mu), axis=0)
                if n_all else jnp.ones((B,), bool)
            )
        )

        c_full = jnp.concatenate(
            [defect.transpose(1, 0, 2).reshape(S * sd, B), pin, c_term],
            axis=0,
        )
        return dZ, nu_inf, first_order, jr_dz, ok, r, c_full


def _solve_lanes(problem: _LanesProblem, Z0: _Z, config: NLSConfig):
    """The lanes analog of ``ops.solver.solve_nls`` — identical merit /
    line-search / damping / termination logic with explicit per-instance
    ``(B,)`` scalars instead of ``vmap``."""
    with jax.default_matmul_precision("float32"):
        return _solve_lanes_impl(problem, Z0, config)


def _solve_lanes_impl(problem: _LanesProblem, Z0: _Z, config: NLSConfig):
    dtype = Z0.u.dtype
    B = problem.B
    n_ls = config.max_line_search_iterations
    alphas = [0.5 ** i for i in range(n_ls)]
    alphas_arr = jnp.asarray(alphas, dtype)
    # All line-search candidates evaluate as ONE folded problem over an
    # (alphas x instances) lane axis — one rollout instead of n_ls.
    trials = problem.tiled(n_ls)
    alpha_fold = jnp.broadcast_to(
        alphas_arr[:, None], (n_ls, B)
    ).reshape(n_ls * B)

    def rep_trials(arr):
        return _fold_lanes(arr, n_ls, B)  # same fold as problem.tiled()

    def iteration(carry, _):
        Z, lam, mu, merit_prev, done, term, fo_carry = carry
        dZ, nu_inf, first_order, jr_dz, qp_ok, r, c = problem.condensed_step(
            Z, lam
        )
        cost = 0.5 * jnp.sum(r * r, axis=0)
        viol1 = jnp.sum(jnp.abs(c), axis=0)
        dZ = _Z(
            xs=jnp.where(qp_ok, dZ.xs, jnp.zeros_like(dZ.xs)),
            u=jnp.where(qp_ok, dZ.u, jnp.zeros_like(dZ.u)),
        )

        mu_new = jnp.maximum(mu, config.penalty_multiplier_margin * nu_inf)
        phi0 = cost + mu_new * viol1
        dphi = jr_dz - mu_new * viol1

        Z_f = _Z(xs=rep_trials(Z.xs), u=rep_trials(Z.u))
        dZ_f = _Z(xs=rep_trials(dZ.xs), u=rep_trials(dZ.u))
        Za = trials.retract(Z_f, dZ_f, alpha_fold)
        ra, ca = trials.evaluate(Za)
        cost_a = 0.5 * jnp.sum(ra * ra, axis=0).reshape(n_ls, B)
        viol_a = jnp.sum(jnp.abs(ca), axis=0).reshape(n_ls, B)
        phi_trials = cost_a + mu_new[None] * viol_a  # (A, B)
        phi_trials = jnp.where(jnp.isfinite(phi_trials), phi_trials, jnp.inf)
        # Few-ulp merit slack: see NLSConfig.merit_slack_ulps (without it,
        # noise-level rejections ratchet lambda to spurious MAX_LAMBDA).
        slack = (
            config.merit_slack_ulps * jnp.finfo(dtype).eps * jnp.abs(phi0)
        )
        accepts = phi_trials <= phi0 + config.armijo_c1 * (
            alphas_arr[:, None] * dphi
        ) + slack
        any_accept = jnp.any(accepts, axis=0) & qp_ok
        first_idx = jnp.argmax(accepts, axis=0)  # (B,)
        alpha_used = jnp.where(any_accept, alphas_arr[first_idx], 0.0)
        # The accepted iterate: retraction is deterministic, so
        # re-retracting at the accepted alpha reproduces the trial exactly
        # (elementwise only — no rollout) without gathering trial trees.
        Z_acc = problem.retract(Z, dZ, alpha_used)
        phi_new = jnp.where(
            any_accept,
            jnp.take_along_axis(phi_trials, first_idx[None], axis=0)[0],
            phi0,
        )

        lam_next = jnp.where(
            any_accept,
            lam * config.lambda_decrease,
            jnp.maximum(
                lam * config.lambda_increase, config.lambda_failure_floor
            ),
        )
        Z_next = _Z(
            xs=jnp.where(any_accept, Z_acc.xs, Z.xs),
            u=jnp.where(any_accept, Z_acc.u, Z.u),
        )

        # merit_prev is +inf on iteration 0: keep the inf out of the
        # division (inf/inf -> NaN trips NaN debugging / checkify).
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

        Z_out = _Z(
            xs=jnp.where(done, Z.xs, Z_next.xs),
            u=jnp.where(done, Z.u, Z_next.u),
        )
        lam_out = jnp.where(done, lam, lam_next)
        mu_out = jnp.where(done, mu, mu_new)
        merit_out = jnp.where(done, merit_prev, phi_new)
        term_out = jnp.where(done, term, new_term)
        fo_out = jnp.where(done, fo_carry, first_order)
        done_out = done | now_done

        trace = (
            jnp.where(done, jnp.nan, cost),
            jnp.where(done, jnp.nan, jnp.max(jnp.abs(c), axis=0)),
            jnp.where(done, jnp.nan, lam),
            jnp.where(done, 0.0, alpha_used),
            jnp.where(done, jnp.nan, first_order),
            ~done,
        )
        return (
            (Z_out, lam_out, mu_out, merit_out, done_out, term_out, fo_out),
            trace,
        )

    init = (
        Z0,
        jnp.full((B,), config.lambda_initial, dtype),
        jnp.full((B,), config.equality_penalty_initial, dtype),
        jnp.full((B,), jnp.inf, dtype),
        jnp.zeros((B,), bool),
        jnp.full((B,), NLSTerminationState.MAX_ITERATIONS, jnp.int32),
        jnp.full((B,), jnp.inf, dtype),
    )
    (Z, lam, _, _, _, term, first_order), traces = jax.lax.scan(
        iteration, init, None, length=config.max_iterations
    )
    iter_cost, iter_viol, iter_lambda, iter_alpha, iter_first, applied = traces

    r, c = problem.evaluate(Z)
    cost = 0.5 * jnp.sum(r * r, axis=0)
    viol = jnp.max(jnp.abs(c), axis=0) if c.shape[0] else jnp.zeros((B,), dtype)

    outputs = NLSOutputs(
        termination_state=term,
        n_iterations=jnp.sum(applied.astype(jnp.int32), axis=0),
        cost=cost,
        constraint_violation=viol,
        first_order_norm=first_order,
        lambda_final=lam,
        # (iters, B) -> (B, iters): match vmap(solve_nls) output layout.
        iter_cost=iter_cost.T,
        iter_violation=iter_viol.T,
        iter_lambda=iter_lambda.T,
        iter_step_size=iter_alpha.T,
        iter_first_order=iter_first.T,
    )
    return Z, outputs


# ---------------------------------------------------------------------- step
def step_lanes(mpc: MPC, state: MPCState, x_current, dynamics_params,
               b_x_set_point=0.0):
    """Batched MPC step in the lanes layout — drop-in for
    ``vmap(mpc.step)``: inputs/outputs carry a LEADING batch axis
    (``state`` leaves ``(B, ...)``, ``x_current`` ``(B, sd)``); internally
    the batch lives in the trailing lane axis.

    Requires ``kkt_method="condensed"`` and a model with machine-generated
    analytic Jacobians (both models ship them).
    """
    spec = mpc.spec
    if mpc.params.kkt_method != "condensed":
        raise ValueError(
            "step_lanes implements the condensed KKT path only; got "
            f"kkt_method={mpc.params.kkt_method!r}"
        )
    if mpc.model.dynamics_jac is None:
        raise ValueError(
            "step_lanes needs model.dynamics_jac (machine-generated "
            "closed-form Jacobians)"
        )
    x_current = jnp.asarray(x_current)
    B, sd = x_current.shape
    dtype = x_current.dtype
    K, sp, N = spec.window_length, spec.spacing, spec.num_states
    xc = x_current.T  # (sd, B)
    set_point = jnp.broadcast_to(
        jnp.asarray(b_x_set_point, dtype), (B,)
    )

    # Warm/cold start (optimization.cc:50-67), elementwise over instances.
    u_prev = state.previous_solution[:, spec.u_start:].astype(dtype).T  # (K,B)
    u_warm = jnp.concatenate([u_prev[1:], u_prev[-1:]])
    k = jnp.arange(K, dtype=dtype)
    u_cold = (
        mpc.params.u_guess_sinusoid_amplitude
        * jnp.sin(k / K * (2.0 * math.pi))
    )[:, None]
    warm = state.warm  # (B,) bool
    u_guess = jnp.where(warm, u_warm, u_cold)
    u_prev_cont = jnp.where(warm, u_prev[0], jnp.zeros((B,), dtype))

    fold = _param_folder(dynamics_params, B)
    dp = fold(1)
    angle = mpc.model.angle_indices
    core = mpc.model.dynamics_core
    if core is not None:
        # Rows (SoA) rollouts for the guess fill and predicted states.
        xc_rows = tuple(xc[i] for i in range(sd))
        fr = lambda xr, u_: core(dp, xr, u_)
        _, steps = rollout_rows(
            fr, xc_rows, u_guess, mpc.params.control_dt, angle,
            stack_states=True,
        )  # row tuple of (K, B)
        shoot = jnp.stack(
            [
                jnp.concatenate([xc[i][None], steps[i][sp - 1::sp]], axis=0)
                for i in range(sd)
            ]
        )  # (sd, N, B)
    else:
        f = lambda x_, u_: mpc.model.dynamics(dp, x_, u_)
        _, xs_roll = rollout_lanes(
            f, xc, u_guess, mpc.params.control_dt, angle, stack_states=True
        )  # xs_roll (sd, K, B)
        shoot = jnp.concatenate(
            [xc[:, None, :], xs_roll[:, sp - 1::sp, :]], axis=1
        )  # (sd, N, B)
    Z0 = _Z(xs=shoot, u=u_guess)

    problem = _LanesProblem(spec, xc, set_point, u_prev_cont, dynamics_params)
    Z, solver_outputs = _solve_lanes(problem, Z0, mpc.nls_config)

    u_out = Z.u  # (K, B)
    if core is not None:
        _, steps2 = rollout_rows(
            fr, xc_rows, u_out, mpc.params.control_dt, angle,
            stack_states=True,
        )
        predicted = jnp.stack(steps2)  # (sd, K, B)
    else:
        _, predicted = rollout_lanes(
            f, xc, u_out, mpc.params.control_dt, angle, stack_states=True
        )  # (sd, K, B)

    def pack(zt: _Z):
        """Lanes iterate -> batch-first packed decision vector (B, dim)."""
        xs_b = jnp.transpose(zt.xs, (2, 1, 0)).reshape(B, N * sd)
        return jnp.concatenate([xs_b, zt.u.T], axis=1)

    z_guess = pack(Z0)
    z_sol = pack(Z)
    outputs = MPCOutputs(
        initial_state=x_current,
        previous_solution=z_guess,
        solver=solver_outputs,
        u=u_out.T,  # (B, K)
        predicted_states=jnp.transpose(predicted, (2, 1, 0)),  # (B, K, sd)
        solution=z_sol,
    )
    new_state = MPCState(
        previous_solution=z_sol, warm=jnp.ones((B,), bool)
    )
    return outputs, new_state


# ----------------------------------------------------------------- simulator
def simulator_step_lanes(
    dynamics_params,
    x,
    dt: float,
    u,
    f_base=None,
    f_mass=None,
    model=SINGLE_CARTPOLE,
    internal_dt: float = 1.0e-3,
):
    """Plant substep integration, batch-last: ``x`` (sd, B), ``u`` (B,),
    forces ``(2, B)`` or ``(2,)``. Same 1 kHz fixed-substep arithmetic as
    ``mpc/simulator.py`` (``simulator.cc:17-23``)."""
    from ..ops.integrate import split_substeps

    n_full, remainder = split_substeps(dt, internal_dt)
    hs = [internal_dt] * n_full
    if remainder:
        hs.append(remainder)

    if f_base is None and f_mass is None and model.dynamics_core is not None:
        # Rows (SoA) substeps — the hot closed-loop case (external pokes
        # go through the packed path below, whose per-mass force mapping
        # is model-specific). Equal substeps run in one scan; the
        # remainder substep (different h) is a single extra step.
        from ..ops.lanes import rk4_step_rows, rollout_rows, wrap_angles_rows

        sd = x.shape[0]
        rows = tuple(x[i] for i in range(sd))
        fr = lambda xr, u_: model.dynamics_core(dynamics_params, xr, u_)
        u = jnp.asarray(u)
        if n_full:
            rows = rollout_rows(
                fr, rows, jnp.broadcast_to(u, (n_full,) + u.shape),
                internal_dt, model.angle_indices,
            )
        if remainder:
            rows = rk4_step_rows(fr, rows, u, remainder)
            rows = wrap_angles_rows(rows, model.angle_indices)
        return jnp.stack(rows)

    def f(x_, u_):
        return model.dynamics(dynamics_params, x_, u_, f_base, f_mass)

    from ..ops.lanes import rk4_step_lanes, wrap_angles_lanes

    for h in hs:
        x = rk4_step_lanes(f, x, u, h)
        x = wrap_angles_lanes(x, model.angle_indices)
    return x


# ---------------------------------------------------------------- closed loop
def run_closed_loop_lanes(
    mpc: MPC,
    x0,
    dynamics_params,
    num_steps: int,
    set_point=0.0,
    mpc_state: MPCState | None = None,
    auto_reset: bool = True,
    disturbances=None,
) -> ClosedLoopResult:
    """Lanes-layout drop-in for ``vmap(run_closed_loop)``: ``x0`` is
    ``(B, sd)``, results carry a leading batch axis. One ``lax.scan`` over
    control ticks; each tick is a lanes MPC solve + lanes plant substeps
    (the reference's browser-loop regime, ``application.ts:424-458``).

    ``disturbances``: optional ``(B, num_steps, 2, 2)`` external plant
    forces (``[:, :, 0]`` base, ``[:, :, 1]`` pole mass), invisible to the
    planner.
    """
    x0 = jnp.asarray(x0)
    B, sd = x0.shape
    dtype = x0.dtype
    if mpc_state is None:
        mpc_state = MPCState(
            previous_solution=jnp.zeros((B, mpc.spec.dim), dtype),
            warm=jnp.zeros((B,), bool),
        )
    set_point = jnp.broadcast_to(jnp.asarray(set_point, dtype), (B,))
    if disturbances is not None:
        # (B, T, 2, 2) -> (T, 2, 2, B) for the scan.
        disturbances = jnp.transpose(
            jnp.asarray(disturbances, dtype), (1, 2, 3, 0)
        )

    def body(carry, dist):
        x, st = carry  # x (sd, B), st batch-first MPCState
        outputs, st2 = step_lanes(mpc, st, x.T, dynamics_params, set_point)
        u0 = outputs.u[:, 0]  # (B,)
        if auto_reset:
            failed = mpc.failure_mask(outputs)
            st2 = mpc.reset_where(st2, failed)
            u0 = jnp.where(failed, jnp.zeros_like(u0), u0)
        f_base = dist[0] if dist is not None else None
        f_mass = dist[1] if dist is not None else None
        x_next = simulator_step_lanes(
            dynamics_params, x, mpc.params.control_dt, u0,
            f_base, f_mass, model=mpc.model,
        )
        tick = (
            x.T,
            u0,
            outputs.predicted_states[:, -1, :],
            outputs.solver.termination_state,
            outputs.solver.constraint_violation,
            outputs.solver.n_iterations,
        )
        return (x_next, st2), tick

    (x_final, st_final), ticks = jax.lax.scan(
        body, (x0.T, mpc_state), disturbances, length=num_steps
    )
    states, controls, term_pred, term_codes, violations, iters = ticks
    # (T, B, ...) -> (B, T, ...) to match vmap(run_closed_loop).
    swap = lambda a: jnp.swapaxes(a, 0, 1)
    return ClosedLoopResult(
        final_state=x_final.T,
        final_mpc_state=st_final,
        states=swap(states),
        controls=swap(controls),
        terminal_predictions=swap(term_pred),
        termination_states=swap(term_codes),
        constraint_violations=swap(violations),
        solver_iterations=swap(iters),
    )
