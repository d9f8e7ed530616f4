"""Differentiable MPC: exact gradients THROUGH the receding-horizon solve.

A capability the reference's C++/WASM stack cannot offer and a flagship
reason to build this framework on JAX: the solve itself becomes a
differentiable function of the problem data. ``make_differentiable_solve``
wraps one MPC solve in a ``jax.custom_vjp`` whose backward pass applies
the KKT implicit function theorem at the solver's solution — no
differentiating through the (fixed-trip, line-searched, LM-damped)
iteration itself, so gradients are exact at convergence and cost one
linear solve, not 8 unrolled GN iterations.

Math. The solve returns ``z*`` minimizing ``1/2 ||r(z, θ)||²`` subject to
``c(z, θ) = 0`` (multiple-shooting defects, initial-state pin, terminal
equalities — ``mpc/problem.py``), with bound clamps on controls and cart
position applied by retraction. At a regular solution there exist
multipliers ``ν*`` with stationarity ``g(z*, ν*, θ) = ∇_z L = 0`` where
``L = 1/2||r||² + νᵀc``. The implicit function theorem on
``F(z, ν, θ) = [g; c] = 0`` gives

    d(z,ν)/dθ = -(∂F/∂(z,ν))⁻¹ ∂F/∂θ,

so the VJP of ``z*`` with cotangent ``w`` is ``-λᵀ ∂F/∂θ`` with
``(∂F/∂(z,ν))ᵀ λ = [w; 0]``. ``∂F/∂z`` uses the TRUE Hessian of the
Lagrangian (via ``jax.grad``), not the solver's Gauss-Newton
approximation, so gradients match finite differences to solver-convergence
accuracy (``tests/test_diff.py``).

Active bounds (measured 2026-08-20, round 4): the forward solver enforces
bounds by retraction (clamping the GN step — the reference's scheme,
optimization.cc:319-328). Under saturation its limit point is NOT a KKT
point of the bound-constrained problem, and — the round-4 finding — it is
not a clean "clamp fixed point" either: measured saturated limits are
λ-STABILIZED STALLS. At the round-3 test point the solver terminates
MAX_LAMBDA (λ ratchets to 2.5e6 in a rejection loop); at a milder point
it converges by relative tolerance with λ_final ~1e3, where the damped GN
step is ~0 but the λ→0 step does NOT vanish on the inactive coordinates
(measured ||d_inactive|| 0.38 at λ→0 vs 1e-5 at λ_final). The stall
location depends on the damping schedule's history, so NO implicit
system — neither the interior KKT, nor Dirichlet-frozen active rows, nor
the full clamp-fixed-point system [GN stationarity in d; linearized
feasibility; active pins] implemented below — reproduces d(solve)/dθ
there (all measured 20–40% off finite differences). ``method="unrolled"``
differentiates the algorithm itself and is exact there: measured ~1e-8
relative FD agreement at a clamped stall (tests assert rtol 1e-3,
``tests/test_diff_saturation.py``).

The ``"ift"`` backward therefore solves the unified clamp-fixed-point
system: exact at interior convergence (d ≡ 0 collapses it to the plain
KKT IFT; FD-verified <3e-7), well-posed best-effort at clamps, with
``dz_i/dθ = 0`` through every clamped coordinate. For EXACT saturated
gradients use ``method="unrolled"`` — it differentiates the fixed-trip
algorithm itself and matches FD at a measured clamped stall (~1e-8
measured; rtol 1e-3 asserted) —
and read ``with_diagnostics=True`` to detect the regime at runtime
(``n_active > 0``, or a MAX_LAMBDA ``termination_state``).
Differentiation wrt θ = (x_current, dynamics_params, set_point); the warm
start selects the local basin and correctly carries no gradient.

The adjoint KKT matrix is assembled from the problem's SEPARABLE second
derivatives — ``∇²cost`` (dynamics-free) plus one vmapped ``(sd+spacing)²``
Hessian per shooting segment, scattered into place — never as a monolithic
``jacfwd`` of the stationarity map over the whole window. That exploits
the multiple-shooting sparsity (O(N·k³) instead of O(n²) second-order AD,
and small dense per-segment programs batch well), and it
also dodges a measured XLA:CPU miscompile: whole-window second-order
programs beyond ~8 segments corrupt the heap on this image (glibc abort;
4-segment windows are fine — the per-segment assembly is immune at any
window length). The assembled matrix is dense ``n × n`` with
``n = dim(z) + n_constraints`` (≈115 at reference defaults), solved with
``jnp.linalg.solve``. Batch with ``jax.vmap`` as usual.

No reference-file citation: the reference has no equivalent (its solver is
an opaque C++ submodule); this module exists because this stack is built
from pure JAX functions end to end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_differentiable_solve"]


def make_differentiable_solve(mpc, bound_tol: float = 1e-6,
                              multiplier_ridge: float = 1e-12,
                              with_diagnostics: bool = False,
                              method: str = "ift"):
    """Build ``solve(x_current, dynamics_params, set_point, state) -> z``
    with exact implicit-function-theorem gradients wrt
    ``(x_current, dynamics_params, set_point)``.

    ``mpc`` is the static controller definition (``make_mpc``); ``state``
    is the warm-start ``MPCState`` (gradient-free by construction). The
    returned ``z`` is the full decision vector; slice
    ``z[mpc.spec.u_start:]`` for the control window and ``z[... : u_start]``
    for the shooting states. Compose into larger differentiable programs
    (losses over ``u``, predicted rollouts, closed-loop imitation) freely.

    ``with_diagnostics=True`` returns ``(z, diag)`` instead, where
    ``diag`` is ``{"active": (dim,) bool, "n_active": int32}`` — the
    bound active set the backward pass will differentiate around. A
    nonzero ``n_active`` is the runtime signal that the solve sits at a
    clamp fixed point (gradients then use the clamp-fixed-point system
    below and are FD-exact only while the active set is locally
    constant; FD across an activation boundary is one-sided).

    Gradients are exact when the forward solver has converged (run enough
    ``max_iterations``; f64 recommended for gradient work) and the bound
    active set is locally constant. ``bound_tol`` decides which
    coordinates count as clamped.

    ``method`` selects the backward pass:

    - ``"ift"`` (default): one adjoint linear solve on the implicit
      system — exact at interior convergence (FD-verified <3e-7),
      best-effort at clamp stalls (measured 20–40% FD deviation there;
      see the module docstring for why no implicit system can be exact
      at a damping-stabilized stall).
    - ``"unrolled"``: differentiates the fixed-trip solver itself —
      ALGORITHM-exact everywhere (a.e.), including saturated solves
      (FD agreement at a clamped stall: ~1e-8 measured, rtol 1e-3
      asserted by ``tests/test_diff_saturation.py``). Costs ``n_θ`` extra
      forward solves: the backward contracts FORWARD-mode Jacobians
      (``jacfwd`` over x/dynamics_params/set_point) because XLA:CPU
      MISCOMPILES the transposed (reverse-mode) program of the condensed
      path — measured 2026-08-20: ``jax.grad`` through two or more
      condensed GN iterations is silently ~20% wrong while ``jax.jvp``
      matches finite differences to 1e-6 and both agree with jit
      disabled. Forward-over-solve is immune.
    """
    if method not in ("ift", "unrolled"):
        raise ValueError(f"unknown method {method!r}")
    spec = mpc.spec
    p = mpc.params

    def _u_prev_continuity(state, dtype):
        # mpc/controller.py::_initial_guess — the u-derivative cost's
        # continuity anchor is the warm start's first control (0 cold).
        u_prev = state.previous_solution.astype(dtype)[spec.u_start:]
        return jnp.where(state.warm, u_prev[0], jnp.zeros((), dtype))

    def _limits(dtype):
        u_mask = jnp.asarray(spec._u_mask)
        pos_mask = jnp.asarray(spec._pos_mask)
        return jnp.where(
            u_mask, jnp.asarray(p.u_limit, dtype),
            jnp.where(pos_mask, jnp.asarray(p.b_x_limit, dtype),
                      jnp.asarray(jnp.inf, dtype)),
        )

    def _active_mask(z):
        return jnp.abs(z) >= _limits(z.dtype) - bound_tol

    def _forward(x, dp, sp, state):
        outputs, _new_state = mpc.step(state, x, dp, b_x_set_point=sp)
        z = outputs.solution
        active = _active_mask(z)
        return z, {"active": active,
                   "n_active": jnp.sum(active.astype(jnp.int32)),
                   "termination_state": outputs.solver.termination_state}

    @jax.custom_vjp
    def solve(x, dp, sp, state):
        return _forward(x, dp, sp, state)

    def fwd(x, dp, sp, state):
        z, diag = _forward(x, dp, sp, state)
        return (z, diag), (z, x, dp, sp, state)

    # Static scatter map: segment s's local variables are
    # (x_s, u_segment_s) — the only z-coordinates its defect touches
    # nonlinearly (multiple-shooting separability, mpc/problem.py).
    sd, k, n_seg = spec.state_dim, spec.spacing, spec.num_states - 1
    _idx = np.empty((n_seg, sd + k), np.int32)
    for _s in range(n_seg):
        _idx[_s, :sd] = np.arange(_s * sd, (_s + 1) * sd)
        _idx[_s, sd:] = spec.u_start + np.arange(_s * k, (_s + 1) * k)
    n_def = n_seg * sd

    def bwd(res, w):
        # Accelerator f32 matmuls may run at reduced precision by default
        # (TF32 on NVIDIA tensor cores); the IFT assembly (Hessians, the
        # n x n adjoint solve) needs true f32 the same way the solver's
        # normal equations do, or the f32 ift gradient is O(1) wrong.
        with jax.default_matmul_precision("float32"):
            return _bwd_impl(res, w)

    def _bwd_impl(res, w):
        z, x, dp, sp, state = res
        wz = w[0]  # the diag cotangent (w[1]) is integer/bool: no flow
        dtype = z.dtype
        nz = spec.dim
        u_prev = _u_prev_continuity(state, dtype)
        active = _active_mask(z)
        a_f = active.astype(dtype)

        def cost(z_, sp_):
            r = spec.cost_residuals(z_, sp_, u_prev)
            return 0.5 * jnp.sum(r * r)

        def cons(z_, x_, dp_, sp_):
            return spec.constraints(z_, x_, sp_, dp_)

        def static_cons(z_, x_, sp_):
            # Pin + terminal equality rows (dynamics-free; constraint rows
            # n_def..n_c in spec.constraints' ordering).
            xs_, _ = spec._split(z_)
            return spec._linear_eq_residuals(xs_, x_, sp_)

        # ---- The clamp-fixed-point system (see module docstring). The
        # forward solver's limit point satisfies, with d the (unclipped)
        # GN step and μ its multipliers, in the λ→0 damping limit:
        #   E1 (n_z):  Hc d + g + Gᵀ μ = 0      (GN-step stationarity)
        #   E2 (n_c):  G d + c = 0              (linearized feasibility)
        #   E3 (n_z):  active_i ? z_i ∓ lim : d_i = 0
        # Interior solves are the a = 0 special case (d ≡ 0, E2 ⇒ c = 0):
        # the system collapses to the ordinary KKT IFT, so one code path
        # serves both regimes with STATIC shapes (2·n_z + n_c).
        g0 = jax.grad(cost)(z, sp)
        c0 = cons(z, x, dp, sp)
        A = jax.jacfwd(cons)(z, x, dp, sp)          # G, (n_c, n_z)
        n_c = A.shape[0]
        Hc = jax.hessian(cost)(z, sp)               # ∂g/∂z (a.e. constant)

        # Forward-value recovery of (d, μ) at z*: least squares of
        # [Hc D_a, Gᵀ; G D_a, 0] (d̃, μ) = (-g, -c), d = D_a d̃ — the
        # E3 rows eliminated by searching d in the active span only.
        # Solved by QR of the ridge-stacked factor [A_ls; √ridge·I]
        # (min ||A_ls y - b||² + ridge||y||², same minimizer as the
        # normal equations) — never forming A_lsᵀA_ls, which squares the
        # condition of a system containing the near-dependent terminal
        # rows (the Gram-form failure mode documented for the condensed
        # KKT path; double-pole Schur cond ~1e9 would square to ~1e18,
        # far past f32).
        Hd = Hc * a_f[None, :]
        Ad = A * a_f[None, :]
        A_ls = jnp.block([[Hd, A.T], [Ad, jnp.zeros((n_c, n_c), dtype)]])
        b_ls = jnp.concatenate([-g0, -c0])
        n_y = nz + n_c
        stacked = jnp.concatenate([
            A_ls,
            jnp.sqrt(jnp.asarray(multiplier_ridge, dtype))
            * jnp.eye(n_y, dtype=dtype),
        ])
        Qls, Rls = jnp.linalg.qr(stacked)
        y = jax.scipy.linalg.solve_triangular(
            Rls, Qls.T @ jnp.concatenate([b_ls, jnp.zeros((n_y,), dtype)]),
            lower=False,
        )
        d = a_f * y[:nz]
        mu = y[nz:]

        # ---- Jacobian blocks, assembled from SEPARABLE second
        # derivatives. A monolithic jacfwd of the stationarity map over
        # the whole window is both O(n²) wasteful and — measured on this
        # image — miscompiled by XLA:CPU beyond ~8 segments (heap
        # corruption). Curvature splits exactly:
        #   ∂E1/∂z = Hc + Σ_s ∇²[μ_sᵀ seg_s]          (S(μ), scattered)
        #   ∂E2/∂z = G + Σ_s ∂/∂v[∂seg_s/∂v · d_s]    (W(d), scattered)
        # (pin/terminal rows are linear in z — zero curvature a.e.; the
        # Hc·d term is θ- and z-independent a.e. since every cost
        # residual is linear a.e.).
        xs, useg = spec._split(z)
        vs = jnp.concatenate([xs[:-1], useg], axis=1)   # (n_seg, sd+k)
        mu_def = mu[:n_def].reshape(n_seg, sd)
        idx = jnp.asarray(_idx)
        d_v = d[idx]                                    # (n_seg, sd+k)

        def seg_scalar(v, m_s, dp_):
            segf = spec._segment_fn(dp_)
            return jnp.dot(m_s, segf(v[:sd], v[sd:]))

        Hseg = jax.vmap(jax.hessian(seg_scalar), in_axes=(0, 0, None))(
            vs, mu_def, dp)                             # (n_seg, sd+k, sd+k)
        Smu = jnp.zeros((nz, nz), dtype).at[
            idx[:, :, None], idx[:, None, :]].add(Hseg)

        def seg_w_rows(v, d_s, dp_):
            segf = spec._segment_fn(dp_)
            f = lambda vv: segf(vv[:sd], vv[sd:])
            return jax.jacfwd(
                lambda vv: jax.jvp(f, (vv,), (d_s,))[1])(v)  # (sd, sd+k)

        Wseg = jax.vmap(seg_w_rows, in_axes=(0, 0, None))(vs, d_v, dp)
        row_idx = jnp.arange(n_def).reshape(n_seg, sd)
        W = jnp.zeros((n_c, nz), dtype).at[
            row_idx[:, :, None], idx[:, None, :]].add(Wseg)

        eye = jnp.eye(nz, dtype=dtype)
        D_a = a_f[:, None] * eye
        M = jnp.block([
            [Hc + Smu, Hc, A.T],
            [A + W, A, jnp.zeros((n_c, n_c), dtype)],
            [D_a, eye - D_a, jnp.zeros((nz, n_c), dtype)],
        ])
        rhs = jnp.concatenate([wz, jnp.zeros((n_c + nz,), dtype)])
        lam = jnp.linalg.solve(M.T, rhs)
        phi1 = lam[:nz]                 # E1 adjoint
        phi2 = lam[nz:nz + n_c]         # E2 adjoint (E3 is θ-free)

        # ---- θ-gradients: -φᵀ ∂F/∂θ, split into the dynamics-free part
        # (x, sp enter via cost/pin/terminal) and per-segment parts (dp
        # enters via the RK4 chains). New vs the interior-only scheme:
        # E2 contributes both its value term (φ2ᵀ c) and its step
        # coupling (φ2ᵀ ∂(G d)/∂θ — the `gd` jvp below); the static
        # rows' G·d term has constant coefficients and no θ-flow.
        phi2_def = phi2[:n_def].reshape(n_seg, sd)
        phi2_lin = phi2[n_def:]
        nu_lin = mu[n_def:]
        phi1_v = phi1[idx]                              # (n_seg, sd+k)

        def phi_static(x_, sp_):
            def l_static(z_):
                return cost(z_, sp_) + jnp.dot(
                    nu_lin, static_cons(z_, x_, sp_))

            dir_grad = jax.jvp(l_static, (z,), (phi1,))[1]
            return dir_grad + jnp.dot(phi2_lin, static_cons(z, x_, sp_))

        def phi_dyn(dp_):
            def one(v, mu_s, p1_s, p2_s, d_s):
                f = lambda vv: seg_scalar(vv, mu_s, dp_)
                mixed = jax.jvp(f, (v,), (p1_s,))[1]
                fd = lambda vv: seg_scalar(vv, p2_s, dp_)
                gd = jax.jvp(fd, (v,), (d_s,))[1]
                segf = spec._segment_fn(dp_)
                return mixed + gd + jnp.dot(p2_s, segf(v[:sd], v[sd:]))

            return jnp.sum(
                jax.vmap(one)(vs, mu_def, phi1_v, phi2_def, d_v))

        gx, gsp = jax.grad(phi_static, argnums=(0, 1))(x, sp)
        gdp = jax.grad(phi_dyn)(dp)
        neg = lambda t: jax.tree.map(jnp.negative, t)
        g_state = jax.tree.map(jnp.zeros_like, state)
        return neg(gx), neg(gdp), neg(gsp), g_state

    def bwd_unrolled(res, w):
        # Forward-mode Jacobians of the unrolled fixed-trip solver,
        # contracted with the cotangent. Exact for the algorithm a.e.
        # (clamps, line search, damping schedule included), and immune to
        # the XLA:CPU transpose miscompile documented above because no
        # reverse-mode program over the solver is ever built.
        z, x, dp, sp, state = res
        wz = w[0]

        def f(x_, dp_, sp_):
            return _forward(x_, dp_, sp_, state)[0]

        Jx, Jdp, Jsp = jax.jacfwd(f, argnums=(0, 1, 2))(x, dp, sp)
        contract = lambda J: jnp.tensordot(wz, J, axes=((0,), (0,)))
        g_state = jax.tree.map(jnp.zeros_like, state)
        return (jax.tree.map(contract, Jx), jax.tree.map(contract, Jdp),
                jax.tree.map(contract, Jsp), g_state)

    solve.defvjp(fwd, bwd if method == "ift" else bwd_unrolled)
    if with_diagnostics:
        return solve
    return lambda x, dp, sp, state: solve(x, dp, sp, state)[0]
