"""Numerical integration ops: angle wrap, RK4, and `lax.scan` rollouts.

Capability parity with ``/root/reference/optimization/integration.hpp`` — but
compiled and batched: the reference hand-propagates RK4 Jacobians through the four
stages by chain rule (``integration.hpp:36-46``); here a rollout is a plain
``lax.scan`` and Jacobians of *anything* (one step, a whole segment, the full
window) come from ``jax.jacfwd`` of the pure function, so the chain-rule code
simply does not exist. Fixed trip counts and static shapes keep every function
jit/vmap/shard_map compatible.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "mod_pi",
    "wrap_angles",
    "rk4_step",
    "rk4_step_with_jac",
    "rollout",
    "segment_rollout_with_jac",
    "split_substeps",
    "substep_rollout",
]

_TWO_PI = 2.0 * math.pi


def mod_pi(angle):
    """Wrap an angle to ``(-pi, pi]``, branch-free.

    Same contract as the reference ``mod_pi`` (``integration.hpp:64-73``),
    including the half-open boundary: ``mod_pi(pi) == pi``, ``mod_pi(-pi) == pi``.
    Identity: ``pi - mod(pi - angle, 2*pi)`` maps exactly onto ``(-pi, pi]``.
    """
    angle = jnp.asarray(angle)
    pi = jnp.asarray(math.pi, dtype=angle.dtype)
    return pi - jnp.mod(pi - angle, _TWO_PI)


def wrap_angles(x, angle_indices: Tuple[int, ...]):
    """Apply ``mod_pi`` to the given coordinates of a state vector."""
    for i in angle_indices:
        x = x.at[..., i].set(mod_pi(x[..., i]))
    return x


def rk4_step(f: Callable, x, u, h):
    """One classic 4th-order Runge-Kutta step of ``x' = f(x, u)``.

    ``f`` closes over dynamics params / external forces. Mirrors
    ``runge_kutta_4th_order_no_jacobians`` (``integration.hpp:52-62``);
    the with-Jacobians variant is just ``jax.jacfwd(rk4_step, ...)``.
    """
    k1 = f(x, u)
    k2 = f(x + k1 * (h * 0.5), u)
    k3 = f(x + k2 * (h * 0.5), u)
    k4 = f(x + k3 * h, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_step_with_jac(fj: Callable, x, u, h):
    """One RK4 step with analytic step Jacobians by the chain rule.

    ``fj(x, u) -> (x_dot, J_x, J_u)`` supplies closed-form dynamics
    Jacobians (machine-generated; ``models/_*_gen.py``); the four-stage
    chain rule mirrors the capability of the reference's
    ``runge_kutta_4th_order`` (``integration.hpp:13-49``). Used on the
    solver hot path instead of ``jacfwd``: every operation stays a full
    (batch,)-lane scalar op or a tiny ``state_dim``-square product.

    Returns ``(x_next, A, B)`` with ``A = dx_next/dx`` (sd, sd) and
    ``B = dx_next/du`` (sd,).
    """
    sd = x.shape[-1]
    eye = jnp.eye(sd, dtype=x.dtype)

    k1, A1, B1 = fj(x, u)
    # Stage sensitivities: dki/dx and dki/du at the stage points.
    x2 = x + k1 * (h * 0.5)
    k2, A2, B2 = fj(x2, u)
    dk2_dx = A2 @ (eye + (h * 0.5) * A1)
    dk2_du = A2 @ ((h * 0.5) * B1) + B2

    x3 = x + k2 * (h * 0.5)
    k3, A3, B3 = fj(x3, u)
    dk3_dx = A3 @ (eye + (h * 0.5) * dk2_dx)
    dk3_du = A3 @ ((h * 0.5) * dk2_du) + B3

    x4 = x + k3 * h
    k4, A4, B4 = fj(x4, u)
    dk4_dx = A4 @ (eye + h * dk3_dx)
    dk4_du = A4 @ (h * dk3_du) + B4

    x_next = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    A = eye + (h / 6.0) * (A1 + 2.0 * dk2_dx + 2.0 * dk3_dx + dk4_dx)
    B = (h / 6.0) * (B1 + 2.0 * dk2_du + 2.0 * dk3_du + dk4_du)
    return x_next, A, B


def segment_rollout_with_jac(
    fj: Callable,
    x0,
    us,
    h,
    angle_indices: Tuple[int, ...] = (),
):
    """Integrate a control segment accumulating segment Jacobians.

    Chains :func:`rk4_step_with_jac` over the ``T`` controls (the
    reference's per-constraint sequential RK4-with-Jacobians pass,
    ``optimization.cc:110-155``): returns ``(x_end, Jx, Ju)`` with
    ``Jx = dx_end/dx0`` (sd, sd) and ``Ju = dx_end/dus`` (sd, T). The
    angle wrap after each step has unit derivative, so it only touches the
    state, not the accumulated Jacobians.

    Fully unrolled (T = state_spacing is small and static): a ``lax.scan``
    here needs a dynamic-index scatter for the ``Ju`` column and keeps an
    (sd, T) carry in device memory every step.
    """
    sd = x0.shape[-1]
    T = us.shape[-1]
    dtype = x0.dtype

    x = x0
    Jx = jnp.eye(sd, dtype=dtype)
    cols = []
    for k in range(T):
        x, A, B = rk4_step_with_jac(fj, x, us[k], h)
        x = wrap_angles(x, angle_indices)
        Jx = A @ Jx
        cols = [A @ c for c in cols]
        cols.append(B)
    Ju = jnp.stack(cols, axis=1)
    return x, Jx, Ju


def rollout(
    f: Callable,
    x0,
    us,
    h,
    angle_indices: Tuple[int, ...] = (),
):
    """Integrate a control sequence: ``lax.scan`` of RK4 steps.

    Replaces the reference's three hand-written sequential loops
    (``optimization.cc:117-137`` constraint rollout, ``:333-351`` guess fill,
    ``:353-371`` predicted states). Angles are wrapped after every step, as in
    all three.

    Args:
      f: dynamics ``f(x, u) -> x_dot``.
      x0: initial state, shape ``(state_dim,)``.
      us: controls, shape ``(T,)``.
      h: timestep between controls.
      angle_indices: state coordinates to wrap after each step.

    Returns:
      ``(x_final, xs)`` where ``xs`` has shape ``(T, state_dim)`` holding the
      state *after* each control (``xs[-1] == x_final``).
    """

    def step(x, u):
        x_new = rk4_step(f, x, u, h)
        x_new = wrap_angles(x_new, angle_indices)
        return x_new, x_new

    return jax.lax.scan(step, x0, us)


def split_substeps(dt: float, internal_dt: float = 1.0e-3):
    """Static substep schedule for the plant integrator: ``(n_full,
    remainder)`` such that ``dt = n_full * internal_dt + remainder`` with
    ``remainder`` dropped below 1e-12 (``simulator.cc:17-23`` arithmetic).
    Shared by every plant-stepping path so the vmapped and lanes
    simulators can never disagree on the schedule."""
    n_full = int(dt / internal_dt)
    remainder = dt - n_full * internal_dt
    if remainder <= 1e-12:
        remainder = 0.0
    return n_full, remainder


def substep_rollout(
    f: Callable,
    x0,
    u,
    dt: float,
    internal_dt: float = 1.0e-3,
    angle_indices: Tuple[int, ...] = (),
):
    """Integrate a *constant* control over ``dt`` using fixed substeps.

    The plant-simulator integration scheme (``simulator.cc:17-23``): break the
    interval into ``internal_dt`` substeps, with a short final substep when
    ``dt`` is not a multiple (reference: ``min(dt, internal_dt)`` with a
    decreasing remainder — identical arithmetic). ``dt`` must be static.
    """
    n_full, remainder = split_substeps(dt, internal_dt)
    substep_hs = [internal_dt] * n_full
    if remainder:
        substep_hs.append(remainder)

    if len(set(substep_hs)) == 1:
        # Uniform substeps: one scan.
        def step(x, _):
            x_new = wrap_angles(rk4_step(f, x, u, substep_hs[0]), angle_indices)
            return x_new, None

        x, _ = jax.lax.scan(step, x0, None, length=len(substep_hs))
        return x

    x = x0
    for h in substep_hs:
        x = wrap_angles(rk4_step(f, x, u, h), angle_indices)
    return x
