"""Machine-generated cart-pole dynamics — do not edit.

Generated by ``python -m cartpole_tpu.symbolic.generate --version double``
from the SymPy Euler-Lagrange derivation in
``cartpole_tpu/symbolic/lagrangian.py`` (the reference's wrenfold-codegen
analog, ``symbolic/generate.py``).
"""

import functools

import jax.numpy as jnp


N_Q = 3
STATE_DIM = 6

def double_dynamics_core(params, x, u, forces=None):
    """Continuous-time dynamics, rows-out: returns the tuple (qd_0, ..., qdd_0, ...).

    x = [b_x, th_1, th_2, b_v, th_1_v, th_2_v]; params = (m_b, m_1, m_2, l_1, l_2, g);
    forces = (f_b_x, f_b_y, f_1_x, f_1_y, f_2_x, f_2_y) or None."""
    m_b, m_1, m_2, l_1, l_2, g = params
    b_x = x[0]
    th_1 = x[1]
    th_2 = x[2]
    b_v = x[3]
    th_1_v = x[4]
    th_2_v = x[5]
    if forces is None:
        f_b_x, f_b_y, f_1_x, f_1_y, f_2_x, f_2_y = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    else:
        f_b_x = forces[0]
        f_b_y = forces[1]
        f_1_x = forces[2]
        f_1_y = forces[3]
        f_2_x = forces[4]
        f_2_y = forces[5]
    x0 = (1.0/(m_1 + m_2 + m_b))
    x1 = jnp.sin(th_1)
    x2 = l_1*x1
    x3 = m_2*x2
    x4 = -m_1*x2 - x3
    x5 = x1**2
    x6 = l_1**2
    x7 = m_1*x6
    x8 = jnp.cos(th_1)
    x9 = x8**2
    x10 = m_2*x6
    x11 = (1.0/(-x0*x4**2 + x10*x5 + x10*x9 + x5*x7 + x7*x9))
    x12 = jnp.sin(th_2)
    x13 = l_2*x12
    x14 = l_1*x8
    x15 = jnp.cos(th_2)
    x16 = l_2*x15
    x17 = m_2*x16
    x18 = x0*x4
    x19 = m_2*x13
    x20 = x13*x3 + x14*x17 + x18*x19
    x21 = l_2**2
    x22 = x12**2
    x23 = th_1_v**2
    x24 = x14*x23
    x25 = m_2*x24
    x26 = th_2_v**2
    x27 = f_1_x + f_2_x + f_b_x + m_1*x24 + u + x17*x26 + x25
    x28 = g*x14
    x29 = f_1_x*x2 - f_1_y*l_1*x8 + f_2_x*x2 - f_2_y*l_1*x8 - l_1*l_2*m_2*x12*x26*x8 + m_1*x28 + m_2*x28 + x16*x26*x3 + x18*x27
    x30 = (-f_2_x*x13 + f_2_y*l_2*x15 - g*x17 + l_1*l_2*m_2*x1*x15*x23 + l_2*m_2*x0*x12*x27 + x11*x20*x29 - x13*x25)/(-m_2**2*x0*x21*x22 + m_2*x15**2*x21 + m_2*x21*x22 - x11*x20**2)
    x31 = x11*(-x20*x30 - x29)
    qdd_0 = x0*(x19*x30 + x27 - x31*x4)
    qdd_1 = x31
    qdd_2 = x30
    return (b_v, th_1_v, th_2_v, qdd_0, qdd_1, qdd_2)


def double_dynamics(params, x, u, forces=None):
    """Continuous-time x_dot = f(x, u) (packed rows)."""
    return jnp.stack(double_dynamics_core(params, x, u, forces))


def double_dynamics_jac_core(params, x, u, forces=None):
    """Rows-out dynamics + analytic Jacobians: returns (x_dot_rows, J_x_rows, J_u_rows) as nested tuples. Constant entries are Python literals 0.0/1.0 so downstream chain-rule products fold away at compile time.

    x = [b_x, th_1, th_2, b_v, th_1_v, th_2_v]; params = (m_b, m_1, m_2, l_1, l_2, g);
    forces = (f_b_x, f_b_y, f_1_x, f_1_y, f_2_x, f_2_y) or None."""
    m_b, m_1, m_2, l_1, l_2, g = params
    b_x = x[0]
    th_1 = x[1]
    th_2 = x[2]
    b_v = x[3]
    th_1_v = x[4]
    th_2_v = x[5]
    if forces is None:
        f_b_x, f_b_y, f_1_x, f_1_y, f_2_x, f_2_y = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    else:
        f_b_x = forces[0]
        f_b_y = forces[1]
        f_1_x = forces[2]
        f_1_y = forces[3]
        f_2_x = forces[4]
        f_2_y = forces[5]
    x0 = (1.0/(m_1 + m_2 + m_b))
    x1 = jnp.sin(th_1)
    x2 = l_1*x1
    x3 = m_1*x2
    x4 = m_2*x2
    x5 = -x3 - x4
    x6 = x1**2
    x7 = l_1**2
    x8 = m_1*x7
    x9 = jnp.cos(th_1)
    x10 = x9**2
    x11 = m_2*x7
    x12 = x0*x5**2
    x13 = x10*x11 + x10*x8 + x11*x6 - x12 + x6*x8
    x14 = (1.0/(x13))
    x15 = jnp.sin(th_2)
    x16 = l_2*x15
    x17 = x16*x4
    x18 = jnp.cos(th_2)
    x19 = l_2*x18
    x20 = l_1*x9
    x21 = m_2*x20
    x22 = x19*x21
    x23 = x0*x5
    x24 = m_2*x16
    x25 = x17 + x22 + x23*x24
    x26 = l_2**2
    x27 = x15**2
    x28 = m_2**2*x0*x26
    x29 = x27*x28
    x30 = x25**2
    x31 = m_2*x18**2*x26 + m_2*x26*x27 - x14*x30 - x29
    x32 = (1.0/(x31))
    x33 = m_2*x19
    x34 = th_1_v**2
    x35 = x21*x34
    x36 = m_1*x20
    x37 = th_2_v**2
    x38 = f_1_x + f_2_x + f_b_x + u + x33*x37 + x34*x36 + x35
    x39 = x19*x4
    x40 = f_1_x*x2 - f_1_y*l_1*x9 + f_2_x*x2 - f_2_y*l_1*x9 + g*x21 + g*x36 - l_1*l_2*m_2*x15*x37*x9 + x23*x38 + x37*x39
    x41 = -x40
    x42 = x14*x25
    x43 = -f_2_x*x16 + f_2_y*l_2*x18 - g*x33 + l_1*l_2*m_2*x1*x18*x34 + l_2*m_2*x0*x15*x38 - x16*x35 - x41*x42
    x44 = x32*x43
    x45 = -x25*x44 - x40
    x46 = x14*x45
    x47 = -x21 - x36
    x48 = x34*x4
    x49 = x3*x34 + x48
    x50 = -x49
    x51 = x17*x37 + x22*x37
    x52 = f_1_x*x20 + f_1_y*x2 + f_2_x*x20 + f_2_y*x2 - g*l_1*m_1*x1 - g*l_1*m_2*x1 + x0*x38*x47 + x23*x50 + x51
    x53 = x16*x21
    x54 = x0*x24
    x55 = x47*x54
    x56 = -x39 + x53 + x55
    x57 = x14*x41
    x58 = 2*x36
    x59 = 2*x21
    x60 = (-x58 - x59)/x13**2
    x61 = x23*x60
    x62 = x16*x48 + x19*x35
    x63 = -x25*x41*x61 + x42*x52 + x50*x54 - x56*x57 + x62
    x64 = x32*x63
    x65 = 2*x39
    x66 = x16*x59
    x67 = x30*x61 + x42*(2*x55 - x65 + x66)
    x68 = (1.0/(x31**2))
    x69 = x43*x68
    x70 = x67*x69
    x71 = x14*(-x25*x64 - x25*x70 - x44*x56 - x52)
    x72 = x24*x37
    x73 = x15*x18*x28
    x74 = x23*x33
    x75 = x69*(x42*(x65 - x66 + 2*x74) + 2*x73)
    x76 = x23*x72 + x51
    x77 = x39 - x53 + x74
    x78 = x32*(-f_2_x*x19 - f_2_y*x16 + g*l_2*m_2*x15 + l_2*m_2*x0*x18*x38 - x29*x37 - x42*x76 - x57*x77 - x62)
    x79 = x14*(-x25*x75 - x25*x78 - x44*x77 + x76)
    x80 = th_1_v*x59
    x81 = th_1_v*x58 + x80
    x82 = x23*x81
    x83 = x32*(th_1_v*x65 - x16*x80 + x42*x82 + x54*x81)
    x84 = x14*(-x25*x83 - x82)
    x85 = 2*th_2_v
    x86 = -2*l_1*l_2*m_2*th_2_v*x15*x9 + x39*x85 + x74*x85
    x87 = x32*(x42*x86 + x73*x85)
    x88 = x14*(-x25*x87 - x86)
    x89 = x32*(x23*x42 + x54)
    x90 = x14*(-x23 - x25*x89)
    qdd_0 = x0*(x24*x44 + x38 - x46*x5)
    qdd_1 = x46
    qdd_2 = x44
    dq0_x0 = 0
    dq0_x1 = x0*(l_2*m_2*x15*x32*x63 + l_2*m_2*x15*x43*x67*x68 - x12*x45*x60 - x46*x47 - x49 - x5*x71)
    dq0_x2 = x0*(x24*x75 + x24*x78 + x33*x44 - x5*x79 - x72)
    dq0_x3 = 0
    dq0_x4 = x0*(x24*x83 - x5*x84 + x81)
    dq0_x5 = x0*(x24*x87 + x33*x85 - x5*x88)
    dq0_u = x0*(x24*x89 - x5*x90 + 1)
    dq1_x0 = 0
    dq1_x1 = x45*x61 + x71
    dq1_x2 = x79
    dq1_x3 = 0
    dq1_x4 = x84
    dq1_x5 = x88
    dq1_u = x90
    dq2_x0 = 0
    dq2_x1 = x64 + x70
    dq2_x2 = x75 + x78
    dq2_x3 = 0
    dq2_x4 = x83
    dq2_x5 = x87
    dq2_u = x89
    x_dot = (b_v, th_1_v, th_2_v, qdd_0, qdd_1, qdd_2)
    J_x = (
        (0.0, 0.0, 0.0, 1.0, 0.0, 0.0),
        (0.0, 0.0, 0.0, 0.0, 1.0, 0.0),
        (0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
        (dq0_x0, dq0_x1, dq0_x2, dq0_x3, dq0_x4, dq0_x5),
        (dq1_x0, dq1_x1, dq1_x2, dq1_x3, dq1_x4, dq1_x5),
        (dq2_x0, dq2_x1, dq2_x2, dq2_x3, dq2_x4, dq2_x5),
    )
    J_u = (0.0, 0.0, 0.0, dq0_u, dq1_u, dq2_u)
    return x_dot, J_x, J_u


def double_dynamics_jac(params, x, u, forces=None):
    """x_dot = f(x, u) with analytic J_x = df/dx, J_u = df/du (packed)."""
    xd, Jx, Ju = double_dynamics_jac_core(params, x, u, forces)
    _zero = x[0] * 0.0
    x_dot = jnp.stack(xd)
    J_x = jnp.stack([
        jnp.stack([e + _zero for e in row]) for row in Jx
    ])
    J_u = jnp.stack([e + _zero for e in Ju])
    return x_dot, J_x, J_u
