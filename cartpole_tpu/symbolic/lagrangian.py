"""SymPy Euler-Lagrange derivation of the cart-pole dynamics (oracle).

Independent re-derivation of the models in
``/root/reference/symbolic/dynamics_single.py:24-143`` (single: tanh Coulomb
friction, guarded cubic air drag, bumper springs, external point forces) and
``dynamics_double.py:25-148`` (double: conservative only, plus external
forces for interface symmetry with our JAX model). Everything is derived
from the Lagrangian by ``sympy.diff`` — no terms are copied from the JAX
modules — so agreement between the two is a genuine two-implementation
cross-check (the role ``pypendulum`` plays in SURVEY.md §4's test plan; the
reference's C++ cannot be built here because the ``mini_opt`` submodule is
not vendored).

Offline/dev + test usage only: SymPy is imported lazily and nothing here
touches JAX.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

__all__ = [
    "SymbolicModel",
    "derive_single_cartpole",
    "derive_double_cartpole",
    "derive_triple_cartpole",
    "make_numeric_single",
    "make_numeric_double",
    "make_numeric_triple",
]


class SymbolicModel(NamedTuple):
    """A derived model: expressions for q_ddot plus the symbol inventory."""

    qdd_exprs: Sequence  #: accelerations, one sympy expr per coordinate.
    state_syms: Sequence  #: [q..., q_dot...] in state-vector order.
    u_sym: object  #: control force symbol.
    param_syms: Sequence  #: parameter symbols in dataclass field order.
    force_syms: Sequence  #: flattened external-force symbols.


def _euler_lagrange(sym, L, D, q, qd, qdd, gen_forces):
    """Form M(q) qdd = f from d/dt(dL/dqd) - dL/dq + dD/dqd = Q.

    Returns (M, f) with the qdd-dependence isolated: every expression that
    multiplies an acceleration lands in M; the rest (velocity products,
    gravity, dissipation, generalized forces) lands in f.
    """
    n = len(q)
    M = sym.zeros(n, n)
    f = sym.zeros(n, 1)
    for i in range(n):
        # d/dt (dL/dqd_i) expanded by the chain rule over q, qd.
        dL_dqdi = sym.diff(L, qd[i])
        ddt = sym.S.Zero
        for j in range(n):
            ddt += sym.diff(dL_dqdi, q[j]) * qd[j]
            ddt += sym.diff(dL_dqdi, qd[j]) * qdd[j]
        residual = ddt - sym.diff(L, q[i]) + sym.diff(D, qd[i]) - gen_forces[i]
        residual = sym.expand(residual)
        for j in range(n):
            M[i, j] = residual.coeff(qdd[j])
        f[i] = -residual.subs({a: 0 for a in qdd})
    return M, f


def derive_single_cartpole() -> SymbolicModel:
    """Cart + single pole with friction, drag, springs, external forces
    (term-for-term capability of ``dynamics_single.py:63-129``)."""
    import sympy as sym

    b_x, th1, b_v, th1_v = sym.symbols("b_x th_1 b_v th_1_v", real=True)
    bdd, th1dd = sym.symbols("b_dd th_1_dd", real=True)
    u = sym.Symbol("u", real=True)
    m_b, m_1, l_1, g = sym.symbols("m_b m_1 l_1 g", positive=True)
    mu_b, v_mu_b, c_d_1 = sym.symbols("mu_b v_mu_b c_d_1", nonnegative=True)
    x_s, k_s = sym.symbols("x_s k_s", nonnegative=True)
    fbx, fby, fmx, fmy = sym.symbols("f_b_x f_b_y f_m_x f_m_y", real=True)

    q = [b_x, th1]
    qd = [b_v, th1_v]
    qdd = [bdd, th1dd]

    # Kinematics: base at (b_x, 0); pole mass at tip.
    p_base = sym.Matrix([b_x, 0])
    p_mass = sym.Matrix([b_x + l_1 * sym.cos(th1), l_1 * sym.sin(th1)])

    def vel(p):
        return sym.Matrix(
            [sum(sym.diff(p[k], q[j]) * qd[j] for j in range(2)) for k in range(2)]
        )

    v_mass = vel(p_mass)

    # Lagrangian.
    T = (m_b * b_v**2) / 2 + m_1 * (v_mass.T * v_mass)[0, 0] / 2
    V = m_1 * g * p_mass[1]
    L = T - V

    # Cubic air drag from the Rayleigh function D = c_d |v|^3 / 6, entered
    # as explicit generalized forces -dD/dqd with a Piecewise guard on
    # |v|^2 > 0: the raw symbolic derivative divides by |v| and the
    # state/control JACOBIANS of the drag are singular at rest — the same
    # guard the reference applies symbolically
    # (dynamics_single.py:102-108; branch in the generated C++ kernel at
    # single_pendulum_dynamics.hpp:75-84).
    v2 = (v_mass.T * v_mass)[0, 0]
    speed = sym.sqrt(v2)

    def drag_force(i):
        dvi = sym.diff(v2, qd[i]) / 2  # = v . dv/dqd_i
        return sym.Piecewise((-c_d_1 / 2 * speed * dvi, v2 > 0), (0, True))

    # Generalized forces: control, smoothed Coulomb friction, bumper
    # springs (all along b_x), plus external point forces f . dp/dq.
    friction = -mu_b * (m_b + m_1) * g * sym.tanh(b_v / sym.Max(v_mu_b, 1e-6))
    spring = -k_s * sym.Max(0, b_x - x_s) + k_s * sym.Max(0, -x_s - b_x)
    f_base = sym.Matrix([fbx, fby])
    f_mass = sym.Matrix([fmx, fmy])
    Q = []
    for i in range(2):
        gen = (
            f_base.T * sym.Matrix([sym.diff(p_base[k], q[i]) for k in range(2)])
            + f_mass.T * sym.Matrix([sym.diff(p_mass[k], q[i]) for k in range(2)])
        )[0, 0]
        Q.append(gen + drag_force(i))
    Q[0] += u + friction + spring

    M, f = _euler_lagrange(sym, L, sym.S.Zero, q, qd, qdd, Q)
    # No sym.simplify here: it costs minutes on the friction/drag terms and
    # lambdify evaluates the raw solved expressions exactly as well.
    qdd_sol = M.inv() * f

    return SymbolicModel(
        qdd_exprs=[qdd_sol[0], qdd_sol[1]],
        state_syms=[b_x, th1, b_v, th1_v],
        u_sym=u,
        param_syms=[m_b, m_1, l_1, g, mu_b, v_mu_b, c_d_1, x_s, k_s],
        force_syms=[fbx, fby, fmx, fmy],
    )


def derive_double_cartpole() -> SymbolicModel:
    """Cart + two-link pole (``dynamics_double.py:25-148``) with external
    point forces at base and both masses."""
    import sympy as sym

    b_x, th1, th2 = sym.symbols("b_x th_1 th_2", real=True)
    b_v, th1_v, th2_v = sym.symbols("b_v th_1_v th_2_v", real=True)
    bdd, th1dd, th2dd = sym.symbols("b_dd th_1_dd th_2_dd", real=True)
    u = sym.Symbol("u", real=True)
    m_b, m_1, m_2, l_1, l_2, g = sym.symbols("m_b m_1 m_2 l_1 l_2 g", positive=True)
    force_syms = sym.symbols("f_b_x f_b_y f_1_x f_1_y f_2_x f_2_y", real=True)
    fbx, fby, f1x, f1y, f2x, f2y = force_syms

    q = [b_x, th1, th2]
    qd = [b_v, th1_v, th2_v]
    qdd = [bdd, th1dd, th2dd]

    p_base = sym.Matrix([b_x, 0])
    p1 = sym.Matrix([b_x + l_1 * sym.cos(th1), l_1 * sym.sin(th1)])
    p2 = p1 + sym.Matrix([l_2 * sym.cos(th2), l_2 * sym.sin(th2)])

    def vel(p):
        return sym.Matrix(
            [sum(sym.diff(p[k], q[j]) * qd[j] for j in range(3)) for k in range(2)]
        )

    v1, v2 = vel(p1), vel(p2)
    T = (
        m_b * b_v**2 / 2
        + m_1 * (v1.T * v1)[0, 0] / 2
        + m_2 * (v2.T * v2)[0, 0] / 2
    )
    V = m_1 * g * p1[1] + m_2 * g * p2[1]
    L = T - V

    forces = [
        (p_base, sym.Matrix([fbx, fby])),
        (p1, sym.Matrix([f1x, f1y])),
        (p2, sym.Matrix([f2x, f2y])),
    ]
    Q = []
    for i in range(3):
        gen = sym.S.Zero
        for p, fv in forces:
            gen += (fv.T * sym.Matrix([sym.diff(p[k], q[i]) for k in range(2)]))[0, 0]
        Q.append(gen)
    Q[0] += u

    M, f = _euler_lagrange(sym, L, sym.S.Zero, q, qd, qdd, Q)
    # LUsolve, as for the triple: M.inv() expands the adjugate over the
    # full determinant, and XLA:GPU compiled that form's Jacobian into a
    # closed loop ~200x slower per tick and ~5x slower to compile.
    qdd_sol = M.LUsolve(f)

    return SymbolicModel(
        qdd_exprs=list(qdd_sol),
        state_syms=[b_x, th1, th2, b_v, th1_v, th2_v],
        u_sym=u,
        param_syms=[m_b, m_1, m_2, l_1, l_2, g],
        force_syms=list(force_syms),
    )


def derive_triple_cartpole() -> SymbolicModel:
    """Cart + three-link pole chain with external point forces at the base
    and every link mass.

    The reference stops at a WIP two-link derivation
    (``dynamics_double.py:1-3``); this extends the same conservative
    Lagrangian chain one more link — the model-generic layers
    (``models/base.py``, problem builder, solver, lanes path) consume it
    unchanged, which is the point of deriving models rather than
    hand-wiring them (``optimization.cc:197-198`` hard-codes state_dim=4
    with a TODO).
    """
    import sympy as sym

    n = 3  # links
    b_x = sym.Symbol("b_x", real=True)
    ths = list(sym.symbols(f"th_1:{n + 1}", real=True))
    b_v = sym.Symbol("b_v", real=True)
    th_vs = list(sym.symbols(" ".join(f"th_{i}_v" for i in range(1, n + 1)), real=True))
    qdd = list(sym.symbols("b_dd " + " ".join(f"th_{i}_dd" for i in range(1, n + 1)), real=True))
    u = sym.Symbol("u", real=True)
    m_b = sym.Symbol("m_b", positive=True)
    ms = list(sym.symbols(" ".join(f"m_{i}" for i in range(1, n + 1)), positive=True))
    ls = list(sym.symbols(" ".join(f"l_{i}" for i in range(1, n + 1)), positive=True))
    g = sym.Symbol("g", positive=True)
    force_syms = list(
        sym.symbols(
            "f_b_x f_b_y "
            + " ".join(f"f_{i}_x f_{i}_y" for i in range(1, n + 1)),
            real=True,
        )
    )

    q = [b_x] + ths
    qd = [b_v] + th_vs

    # Chain kinematics: each mass hangs one link beyond the previous.
    p_base = sym.Matrix([b_x, 0])
    points = []
    p = p_base
    for i in range(n):
        p = p + sym.Matrix([ls[i] * sym.cos(ths[i]), ls[i] * sym.sin(ths[i])])
        points.append(p)

    def vel(pt):
        return sym.Matrix(
            [
                sum(sym.diff(pt[k], q[j]) * qd[j] for j in range(n + 1))
                for k in range(2)
            ]
        )

    T = m_b * b_v**2 / 2
    V = sym.S.Zero
    for i in range(n):
        v_i = vel(points[i])
        T += ms[i] * (v_i.T * v_i)[0, 0] / 2
        V += ms[i] * g * points[i][1]
    L = T - V

    forces = [(p_base, sym.Matrix(force_syms[0:2]))]
    for i in range(n):
        forces.append((points[i], sym.Matrix(force_syms[2 + 2 * i : 4 + 2 * i])))
    Q = []
    for i in range(n + 1):
        gen = sym.S.Zero
        for pt, fv in forces:
            gen += (fv.T * sym.Matrix([sym.diff(pt[k], q[i]) for k in range(2)]))[0, 0]
        Q.append(gen)
    Q[0] += u

    M, f = _euler_lagrange(sym, L, sym.S.Zero, q, qd, qdd, Q)
    # LUsolve instead of M.inv(): the adjugate of the 4x4 trig mass matrix
    # explodes symbolically; LU keeps the expression DAG compact for CSE.
    qdd_sol = M.LUsolve(f)

    return SymbolicModel(
        qdd_exprs=list(qdd_sol),
        state_syms=[b_x] + ths + [b_v] + th_vs,
        u_sym=u,
        param_syms=[m_b] + ms + ls + [g],
        force_syms=force_syms,
    )


def _lambdify(model: SymbolicModel) -> Callable:
    import sympy as sym

    args = (
        list(model.param_syms)
        + list(model.state_syms)
        + [model.u_sym]
        + list(model.force_syms)
    )
    fns = [sym.lambdify(args, e, "numpy") for e in model.qdd_exprs]
    n_q = len(model.qdd_exprs)

    def f(params_tuple, x, u, forces):
        import numpy as np

        flat = list(params_tuple) + list(x) + [u] + list(forces)
        qdd = [fn(*flat) for fn in fns]
        return np.concatenate([np.asarray(x[n_q:], float), np.asarray(qdd, float)])

    return f


def make_numeric_single() -> Callable:
    """``f(params_tuple9, x4, u, forces4) -> x_dot4`` from the derivation."""
    return _lambdify(derive_single_cartpole())


def make_numeric_double() -> Callable:
    """``f(params_tuple6, x6, u, forces6) -> x_dot6`` from the derivation."""
    return _lambdify(derive_double_cartpole())


def make_numeric_triple() -> Callable:
    """``f(params_tuple8, x8, u, forces8) -> x_dot8`` from the derivation."""
    return _lambdify(derive_triple_cartpole())
