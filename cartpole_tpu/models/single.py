"""Closed-form dynamics of the cart + single pole system, in pure JAX.

This module replaces the reference's entire symbolic-codegen pipeline
(``/root/reference/symbolic/dynamics_single.py`` -> wrenfold ->
``optimization/single_pendulum_dynamics.hpp``): the equations of motion are
derived once by hand from the same Lagrangian and written directly as a JAX
function. Jacobians come for free from ``jax.jacfwd`` instead of generated
analytic-derivative C++.

Model (state ``x = [b_x, th_1, b_x_dot, th_1_dot]``):

* base (cart) of mass ``m_b`` sliding on the x axis, position ``b_x``;
* point mass ``m_1`` at the tip of a massless pole of length ``l_1`` mounted
  on the cart; ``th_1`` is measured from the +x axis, so upright is
  ``th_1 = pi/2``;
* control ``u`` is a horizontal force on the base;
* smoothed Coulomb friction on the base:
  ``-mu_b (m_b + m_1) g tanh(b_x_dot / max(v_mu_b, 1e-6))``
  (same smoothing as ``dynamics_single.py:98-100``);
* cubic air-drag dissipation on the pole mass with Rayleigh function
  ``D = c_d_1 |v|^3 / 6`` whose velocity gradients are guarded against the
  ``|v| = 0`` Jacobian singularity (``dynamics_single.py:102-108``);
* boundary bumper springs ``-k_s max(0, b_x - x_s) + k_s max(0, -x_s - b_x)``
  (``dynamics_single.py:110-112``);
* optional external forces applied at the base and at the pole mass, entering
  through generalized forces (``dynamics_single.py:89-95``).

Euler-Lagrange in the form ``A(x) qdd = rhs(x, u, f)`` with

    A = [[m_b + m_1,        -m_1 l_1 sin(th)],
         [-m_1 l_1 sin(th),  m_1 l_1^2      ]]

which is inverted in closed form (det = m_1 l_1^2 (m_b + m_1 cos^2 th) > 0).
"""

from __future__ import annotations

import jax.numpy as jnp

from .params import SingleCartPoleParams

__all__ = ["single_cartpole_dynamics", "single_cartpole_energy"]

STATE_DIM = 4
#: Indices of angle coordinates inside the state vector (wrapped to (-pi, pi]).
ANGLE_INDICES = (1,)


def _safe_speed(vx, vy):
    """|v| with a zero-safe gradient: returns 0 at v = 0 with zero derivative.

    The drag force is ``-0.5 c_d |v| v`` whose naive ``sqrt`` Jacobian is
    singular at rest; the reference guards this with a symbolic ``where``
    (``dynamics_single.py:104-108``). The standard JAX-safe idiom: keep the
    ``where`` *inside* the sqrt argument so no NaN can enter the gradient.
    """
    n2 = vx * vx + vy * vy
    pos = n2 > 0
    n2_safe = jnp.where(pos, n2, 1.0)
    return jnp.where(pos, jnp.sqrt(n2_safe), 0.0)


def single_cartpole_dynamics(
    params: SingleCartPoleParams,
    x,
    u,
    f_base=None,
    f_mass=None,
):
    """Continuous-time dynamics ``x_dot = f(x, u)``.

    Args:
      params: system parameters (floats or broadcastable arrays).
      x: state ``[b_x, th_1, b_x_dot, th_1_dot]``, shape ``(4,)``.
      u: scalar horizontal control force on the base.
      f_base: optional external force ``(fx, fy)`` applied at the base.
      f_mass: optional external force ``(fx, fy)`` applied at the pole mass.

    Returns:
      ``x_dot`` with shape ``(4,)``.
    """
    x = jnp.asarray(x)
    b_x, th, b_v, th_v = x[0], x[1], x[2], x[3]
    m_b, m_1, l_1, g = params.m_b, params.m_1, params.l_1, params.g

    s, c = jnp.sin(th), jnp.cos(th)

    # Pole-mass velocity: p1 = (b_x + l_1 c, l_1 s) => v1 = d p1 / dt.
    v1x = b_v - l_1 * s * th_v
    v1y = l_1 * c * th_v

    # Generalized external forces: Q_q = f . dp/dq for each applied point.
    # (dtype-pinned: a default-dtype zeros(()) would promote the whole
    # computation to f64 under jax_enable_x64.)
    q_b = jnp.zeros((), x.dtype)
    q_th = jnp.zeros((), x.dtype)
    if f_base is not None:
        f_base = jnp.asarray(f_base)
        q_b = q_b + f_base[0]  # d(base)/d(b_x) = (1, 0); d(base)/d(th) = 0.
    if f_mass is not None:
        f_mass = jnp.asarray(f_mass)
        q_b = q_b + f_mass[0]
        q_th = q_th + l_1 * (-s * f_mass[0] + c * f_mass[1])

    # Smoothed Coulomb friction on the base (force along b_x).
    f_fric = -params.mu_b * (m_b + m_1) * g * jnp.tanh(
        b_v / jnp.maximum(params.v_mu_b, 1e-6)
    )

    # Air drag on the pole mass via the Rayleigh dissipation function
    # D = c_d |v|^3 / 6; generalized drag force on q is -dD/dq_dot:
    #   dD/d(b_v)  = 0.5 c_d |v| v1x
    #   dD/d(th_v) = 0.5 c_d |v| (v1 . dv1/dth_v) = 0.5 c_d |v| l_1 (c v1y - s v1x)
    speed = _safe_speed(v1x, v1y)
    drag_b = 0.5 * params.c_d_1 * speed * v1x
    drag_th = 0.5 * params.c_d_1 * speed * l_1 * (c * v1y - s * v1x)

    # Boundary bumper springs.
    f_spring = -params.k_s * jnp.maximum(0.0, b_x - params.x_s) + params.k_s * jnp.maximum(
        0.0, -params.x_s - b_x
    )

    # Right-hand sides of A(x) qdd = rhs.
    rhs_b = u + q_b + f_fric + f_spring + m_1 * l_1 * c * th_v * th_v - drag_b
    rhs_th = -m_1 * g * l_1 * c + q_th - drag_th

    # Closed-form 2x2 inverse of the mass matrix.
    det = m_1 * l_1 * l_1 * (m_b + m_1 * c * c)
    b_acc = (m_1 * l_1 * l_1 * rhs_b + m_1 * l_1 * s * rhs_th) / det
    th_acc = (m_1 * l_1 * s * rhs_b + (m_b + m_1) * rhs_th) / det

    return jnp.stack([b_v, th_v, b_acc, th_acc])


def single_cartpole_dynamics_jac(params: SingleCartPoleParams, x, u):
    """``(x_dot, J_x, J_u)`` with machine-generated analytic Jacobians.

    Backed by ``models/_single_gen.py`` — emitted by
    ``python -m cartpole_tpu.symbolic.generate --version single --jacobians``
    from the SymPy Euler-Lagrange derivation (the wrenfold-codegen pattern
    of the reference, ``single_pendulum_dynamics.hpp:13-16``). Used on the
    solver hot path: every generated operation is a scalar expression that
    runs on full (batch,)-shaped lanes under ``vmap``, unlike ``jacfwd``
    whose tangent axis would add a dimension to every batched
    intermediate.
    """
    from . import _single_gen

    pt = (
        params.m_b, params.m_1, params.l_1, params.g, params.mu_b,
        params.v_mu_b, params.c_d_1, params.x_s, params.k_s,
    )
    return _single_gen.single_dynamics_jac(pt, jnp.asarray(x), u)


def _gen_params(params: SingleCartPoleParams):
    return (
        params.m_b, params.m_1, params.l_1, params.g, params.mu_b,
        params.v_mu_b, params.c_d_1, params.x_s, params.k_s,
    )


def single_cartpole_dynamics_core(
    params: SingleCartPoleParams, x_rows, u, forces=None
):
    """Rows-out dynamics for structure-of-arrays rollouts: ``x_rows`` is a
    tuple of per-coordinate arrays, the return a matching tuple (no packed
    ``(sd, ...)`` intermediate — the batch-in-lanes padding fix,
    ``ops/lanes.py``). ``forces``: optional ``(f_b_x, f_b_y, f_m_x,
    f_m_y)`` per-point external forces."""
    from . import _single_gen

    return _single_gen.single_dynamics_core(
        _gen_params(params), x_rows, u, forces
    )


def single_cartpole_dynamics_jac_core(params: SingleCartPoleParams, x_rows, u):
    """Rows-out ``(x_dot, J_x, J_u)`` as nested tuples (constant entries
    are Python literals — chain-rule products against them fold away)."""
    from . import _single_gen

    return _single_gen.single_dynamics_jac_core(
        _gen_params(params), x_rows, u
    )


def single_cartpole_energy(params: SingleCartPoleParams, x):
    """Total mechanical energy T + V (test invariant: conserved when
    mu_b = c_d_1 = k_s = 0 and no control/external force)."""
    x = jnp.asarray(x)
    th, b_v, th_v = x[1], x[2], x[3]
    m_b, m_1, l_1, g = params.m_b, params.m_1, params.l_1, params.g
    s, c = jnp.sin(th), jnp.cos(th)
    v1x = b_v - l_1 * s * th_v
    v1y = l_1 * c * th_v
    kinetic = 0.5 * m_b * b_v * b_v + 0.5 * m_1 * (v1x * v1x + v1y * v1y)
    potential = m_1 * g * l_1 * s
    return kinetic + potential
