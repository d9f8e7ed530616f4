"""Batch-in-lanes (batch-last) integration ops.

The vmapped hot path materializes ``(B, sd, sd)``-shaped Jacobian
intermediates: tiny ``(4, 4)`` trailing pages that tiled device layouts
pad and strided accesses waste.

This module keeps the BATCH in the trailing (lane) axis instead: every
intermediate is ``(sd, M)`` or ``(sd, sd, M)`` with ``M`` = thousands of
instances contiguous in memory, so the vector units stream full rows. The
machine-generated scalar dynamics kernels (``models/_single_gen.py`` /
``_double_gen.py``) broadcast over trailing axes by construction, so they
run unmodified on ``x`` of shape ``(sd, M)``; the per-instance Jacobians
come from their closed-form ``J_x``/``J_u`` outputs chained through a
batch-last RK4 (jacfwd cannot produce per-instance Jacobians in this
layout).

Replaces the same reference capability as ``ops/integrate.py`` (the hot loop
of ``/root/reference/optimization/optimization.cc:110-155``); the vmapped
variants remain the generic/autodiff path.

All functions take ONE flattened trailing batch axis ``M``; callers fold
(segments x instances) or (alphas x segments x instances) into it and unfold
after.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp

from .integrate import mod_pi

__all__ = [
    "bmat",
    "bmv",
    "beye",
    "rk4_step_lanes",
    "rk4_step_with_jac_lanes",
    "segment_rollout_with_jac_lanes",
    "rollout_lanes",
    "wrap_angles_lanes",
    "rk4_step_rows",
    "rk4_step_with_jac_rows",
    "rollout_rows",
    "segment_rollout_with_jac_scan",
    "wrap_angles_rows",
]


def bmat(A, B):
    """Batched tiny-matrix product ``(i,j,M) x (j,k,M) -> (i,k,M)``.

    ``j`` is the state dimension (4 or 6): an explicit broadcast-multiply-
    reduce stays fully elementwise over the lane axis (no dot_general, no
    layout shuffle)."""
    return jnp.sum(A[:, :, None] * B[None, :, :], axis=1)


def bmv(A, x):
    """Batched tiny matrix-vector product ``(i,j,M) x (j,M) -> (i,M)``."""
    return jnp.sum(A * x[None, :, :], axis=1)


def beye(n, dtype):
    """Identity broadcastable against ``(n, n, M)``."""
    return jnp.eye(n, dtype=dtype)[:, :, None]


def wrap_angles_lanes(x, angle_indices: Tuple[int, ...]):
    """``mod_pi`` the given leading coordinates of ``x`` (sd, M)."""
    for i in angle_indices:
        x = x.at[i].set(mod_pi(x[i]))
    return x


def rk4_step_lanes(f: Callable, x, u, h):
    """One RK4 step, batch-last: ``x`` (sd, M), ``u`` (M,)."""
    k1 = f(x, u)
    k2 = f(x + k1 * (h * 0.5), u)
    k3 = f(x + k2 * (h * 0.5), u)
    k4 = f(x + k3 * h, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_step_with_jac_lanes(fj: Callable, x, u, h):
    """One RK4 step with analytic chain-ruled Jacobians, batch-last.

    ``fj(x, u) -> (x_dot (sd, M), J_x (sd, sd, M), J_u (sd, M))`` — the
    machine-generated closed-form kernels evaluated on lane-batched inputs.
    Same chain rule as :func:`ops.integrate.rk4_step_with_jac` (capability
    of the reference's ``runge_kutta_4th_order``, ``integration.hpp:13-49``)
    with every product a full-lane elementwise op.

    Returns ``(x_next (sd, M), A (sd, sd, M), B (sd, M))``.
    """
    sd = x.shape[0]
    eye = beye(sd, x.dtype)

    k1, A1, B1 = fj(x, u)
    k2, A2, B2 = fj(x + k1 * (h * 0.5), u)
    dk2_dx = bmat(A2, eye + (h * 0.5) * A1)
    dk2_du = bmv(A2, (h * 0.5) * B1) + B2

    k3, A3, B3 = fj(x + k2 * (h * 0.5), u)
    dk3_dx = bmat(A3, eye + (h * 0.5) * dk2_dx)
    dk3_du = bmv(A3, (h * 0.5) * dk2_du) + B3

    k4, A4, B4 = fj(x + k3 * h, u)
    dk4_dx = bmat(A4, eye + h * dk3_dx)
    dk4_du = bmv(A4, h * dk3_du) + B4

    x_next = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    A = eye + (h / 6.0) * (A1 + 2.0 * dk2_dx + 2.0 * dk3_dx + dk4_dx)
    B = (h / 6.0) * (B1 + 2.0 * dk2_du + 2.0 * dk3_du + dk4_du)
    return x_next, A, B


def segment_rollout_with_jac_lanes(
    fj: Callable,
    x0,
    us,
    h,
    angle_indices: Tuple[int, ...] = (),
):
    """Integrate one shooting segment accumulating Jacobians, batch-last.

    ``x0`` (sd, M), ``us`` (T, M) -> ``(x_end (sd, M), Jx (sd, sd, M),
    Ju (sd, T, M))``. Fully unrolled over the small static T
    (= state_spacing); the angle wrap has unit derivative so it only
    touches the state.
    """
    sd = x0.shape[0]
    T = us.shape[0]
    x = x0
    Jx = jnp.broadcast_to(beye(sd, x0.dtype), (sd, sd, x0.shape[1]))
    cols = []
    for k in range(T):
        x, A, B = rk4_step_with_jac_lanes(fj, x, us[k], h)
        x = wrap_angles_lanes(x, angle_indices)
        Jx = bmat(A, Jx)
        cols = [bmv(A, c) for c in cols]
        cols.append(B)
    Ju = jnp.stack(cols, axis=1)  # (sd, T, M)
    return x, Jx, Ju


def rollout_lanes(
    f: Callable,
    x0,
    us,
    h,
    angle_indices: Tuple[int, ...] = (),
    stack_states: bool = False,
):
    """Integrate a control sequence batch-last (no Jacobians).

    ``x0`` (sd, M), ``us`` (T, M). Unrolled over T (small, static).
    Returns ``x_final`` (sd, M), or ``(x_final, xs (sd, T, M))`` with
    ``stack_states`` (state *after* each control, like
    :func:`ops.integrate.rollout`).
    """
    x = x0
    states = []
    T = us.shape[0]
    for k in range(T):
        x = rk4_step_lanes(f, x, us[k], h)
        x = wrap_angles_lanes(x, angle_indices)
        if stack_states:
            states.append(x)
    if stack_states:
        return x, jnp.stack(states, axis=1)
    return x


# --------------------------------------------------------------------- SoA
# Structure-of-arrays variants: the state is a TUPLE of per-coordinate
# (M,) arrays and Jacobians are nested tuples of entries ((M,) arrays or
# Python 0.0/1.0 literals). No packed (sd, M) intermediate ever exists, so
# there is no at[].set scatter for the angle wrap, and XLA fuses the whole
# RK4 chain freely.


def _axpy_rows(x_rows, k_rows, a):
    """x + a*k, row-tuple-wise."""
    return tuple(x + a * k for x, k in zip(x_rows, k_rows))


def wrap_angles_rows(x_rows, angle_indices: Tuple[int, ...]):
    """``mod_pi`` the given coordinates of a row tuple."""
    return tuple(
        mod_pi(x) if i in angle_indices else x
        for i, x in enumerate(x_rows)
    )


def rk4_step_rows(f: Callable, x_rows, u, h):
    """One RK4 step on a row tuple: ``f(x_rows, u) -> x_dot_rows``."""
    k1 = f(x_rows, u)
    k2 = f(_axpy_rows(x_rows, k1, h * 0.5), u)
    k3 = f(_axpy_rows(x_rows, k2, h * 0.5), u)
    k4 = f(_axpy_rows(x_rows, k3, h), u)
    return tuple(
        x + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for x, a, b, c, d in zip(x_rows, k1, k2, k3, k4)
    )


def rollout_rows(
    f: Callable,
    x0_rows,
    us,
    h,
    angle_indices: Tuple[int, ...] = (),
    stack_states: bool = False,
    unroll: int = 4,
):
    """Rows-tuple rollout: ``us`` (T, M); returns the final row tuple, or
    ``(final, per_step)`` where ``per_step`` is a row tuple of (T, M)
    arrays (state after each control).

    One ``lax.scan`` over T — the RK4 body is compiled once, keeping the
    trace size independent of the horizon (an unrolled K=60 rollout of
    the generated double-pole kernel alone was tens of thousands of HLO
    ops and blew CPU compile memory up). ``unroll`` trades per-iteration
    kernel-launch overhead against trace size."""
    import jax

    def body(x, u):
        x = rk4_step_rows(f, x, u, h)
        x = wrap_angles_rows(x, angle_indices)
        return x, (x if stack_states else None)

    x, states = jax.lax.scan(
        body, tuple(x0_rows), us, unroll=min(unroll, us.shape[0])
    )
    if stack_states:
        return x, states
    return x


def _mat_rows(A, B, sd: int):
    """Nested-tuple matmul ``A @ B`` with 0.0/1.0 literal folding."""

    def term(a, b):
        if isinstance(a, float) and a == 0.0:
            return None
        if isinstance(b, float) and b == 0.0:
            return None
        if isinstance(a, float) and a == 1.0:
            return b
        if isinstance(b, float) and b == 1.0:
            return a
        return a * b

    out = []
    for i in range(sd):
        row = []
        for j in range(sd):
            acc = None
            for k in range(sd):
                t = term(A[i][k], B[k][j])
                if t is None:
                    continue
                acc = t if acc is None else acc + t
            row.append(0.0 if acc is None else acc)
        out.append(tuple(row))
    return tuple(out)


def _matvec_rows(A, v, sd: int):
    """Nested-tuple mat-vec with literal folding; ``v`` a row tuple."""
    out = []
    for i in range(sd):
        acc = None
        for k in range(sd):
            a = A[i][k]
            if isinstance(a, float) and a == 0.0:
                continue
            vk = v[k]
            if isinstance(vk, float) and vk == 0.0:
                continue
            t = vk if isinstance(a, float) and a == 1.0 else (
                a if isinstance(vk, float) and vk == 1.0 else a * vk
            )
            acc = t if acc is None else acc + t
        out.append(0.0 if acc is None else acc)
    return tuple(out)


def _add_scaled_mat(A, B, s, sd: int):
    """A + s*B elementwise over nested tuples with literal folding."""
    out = []
    for i in range(sd):
        row = []
        for j in range(sd):
            a, b = A[i][j], B[i][j]
            if isinstance(b, float) and b == 0.0:
                row.append(a)
            elif isinstance(a, float) and a == 0.0:
                row.append(s * b)
            else:
                row.append(a + s * b)
        out.append(tuple(row))
    return tuple(out)


def _eye_rows(sd: int):
    return tuple(
        tuple(1.0 if i == j else 0.0 for j in range(sd)) for i in range(sd)
    )


def rk4_step_with_jac_rows(fj: Callable, x_rows, u, h):
    """One RK4 step with chain-ruled Jacobians, rows form.

    ``fj(x_rows, u) -> (x_dot_rows, J_x_rows, J_u_rows)`` (nested tuples,
    constants as literals). Returns ``(x_next_rows, A_rows, B_rows)``.
    Same math as :func:`rk4_step_with_jac_lanes`; products against the
    structural 0/1 entries are folded at trace time.
    """
    sd = len(x_rows)
    eye = _eye_rows(sd)

    k1, A1, B1 = fj(x_rows, u)
    k2, A2, B2 = fj(_axpy_rows(x_rows, k1, h * 0.5), u)
    dk2_dx = _mat_rows(A2, _add_scaled_mat(eye, A1, h * 0.5, sd), sd)
    dk2_du = tuple(
        a + b
        for a, b in zip(
            _matvec_rows(A2, tuple((h * 0.5) * e for e in B1), sd), B2
        )
    )

    k3, A3, B3 = fj(_axpy_rows(x_rows, k2, h * 0.5), u)
    dk3_dx = _mat_rows(A3, _add_scaled_mat(eye, dk2_dx, h * 0.5, sd), sd)
    dk3_du = tuple(
        a + b
        for a, b in zip(
            _matvec_rows(A3, tuple((h * 0.5) * e for e in dk2_du), sd), B3
        )
    )

    k4, A4, B4 = fj(_axpy_rows(x_rows, k3, h), u)
    dk4_dx = _mat_rows(A4, _add_scaled_mat(eye, dk3_dx, h, sd), sd)
    dk4_du = tuple(
        a + b
        for a, b in zip(
            _matvec_rows(A4, tuple(h * e for e in dk3_du), sd), B4
        )
    )

    x_next = tuple(
        x + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for x, a, b, c, d in zip(x_rows, k1, k2, k3, k4)
    )
    A = tuple(
        tuple(
            (1.0 if i == j else 0.0)
            + (h / 6.0)
            * (A1[i][j] + 2.0 * dk2_dx[i][j] + 2.0 * dk3_dx[i][j]
               + dk4_dx[i][j])
            for j in range(sd)
        )
        for i in range(sd)
    )
    B = tuple(
        (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for a, b, c, d in zip(B1, dk2_du, dk3_du, dk4_du)
    )
    return x_next, A, B


def segment_rollout_with_jac_scan(
    fj: Callable,
    x0_rows,
    us,
    h,
    angle_indices: Tuple[int, ...] = (),
    unroll: int = 1,
):
    """Shooting-segment Jacobian rollout: SoA inside, packed out.

    The per-step work (dynamics + within-step RK4 chain rule) runs in
    rows form inside ONE ``lax.scan`` body — compiled once instead of
    unrolled T times, which keeps the trace ~T x smaller than an
    unrolled chain while every intermediate stays an unpadded (M,)
    array. The tiny cross-step accumulation
    (``Jx = A_s Jx``, ``Ju`` column updates) runs packed afterwards: a
    handful of (sd, sd, M) ops whose traffic is negligible next to the
    dynamics chain.

    ``x0_rows`` row tuple of (M,); ``us`` (T, M). Returns packed
    ``(x_end (sd, M), Jx (sd, sd, M), Ju (sd, T, M))`` — the same
    contract as :func:`segment_rollout_with_jac_lanes`.
    """
    import jax

    sd = len(x0_rows)
    T, M = us.shape
    dtype = us.dtype

    def pack_mat(A_rows):
        return jnp.stack(
            [
                jnp.stack(
                    [
                        jnp.broadcast_to(jnp.asarray(e, dtype), (M,))
                        for e in row
                    ]
                )
                for row in A_rows
            ]
        )

    def body(x_rows, u):
        x_next, A, B = rk4_step_with_jac_rows(fj, x_rows, u, h)
        x_next = wrap_angles_rows(x_next, angle_indices)
        return tuple(x_next), (pack_mat(A), jnp.stack(B))

    x_rows, (As, Bs) = jax.lax.scan(
        body, tuple(x0_rows), us, unroll=min(unroll, T)
    )
    # As (T, sd, sd, M), Bs (T, sd, M): accumulate across steps (packed,
    # unrolled — O(T^2/2) tiny matvecs).
    Jx = jnp.broadcast_to(beye(sd, dtype), (sd, sd, M))
    cols = []
    for k in range(T):
        A = As[k]
        Jx = bmat(A, Jx)
        cols = [bmv(A, c) for c in cols]
        cols.append(Bs[k])
    Ju = jnp.stack(cols, axis=1)  # (sd, T, M)
    return jnp.stack(x_rows), Jx, Ju
