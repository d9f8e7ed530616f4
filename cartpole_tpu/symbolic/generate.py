"""Code generation: emit a JAX dynamics module from the symbolic derivation.

The ``python -m symbolic.generate`` analog
(``/root/reference/symbolic/generate.py:33-61``): where the reference emits
wrenfold C++ into ``optimization/<name>.hpp``, this emits a self-contained
JAX module (with CSE'd subexpressions) from the SymPy Euler-Lagrange
derivation — the on-ramp for new model families: derive the Lagrangian
symbolically, generate the JAX kernel, drop it into ``models/``.

Usage::

    python -m cartpole_tpu.symbolic.generate --version single > single_gen.py
    python -m cartpole_tpu.symbolic.generate --version double --out d_gen.py
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .lagrangian import (
    SymbolicModel,
    derive_double_cartpole,
    derive_single_cartpole,
    derive_triple_cartpole,
)

__all__ = ["generate_jax_module", "main"]

_HEADER = '''"""Machine-generated cart-pole dynamics — do not edit.

Generated by ``python -m cartpole_tpu.symbolic.generate --version {version}``
from the SymPy Euler-Lagrange derivation in
``cartpole_tpu/symbolic/lagrangian.py`` (the reference's wrenfold-codegen
analog, ``symbolic/generate.py``).
"""

import functools

import jax.numpy as jnp


'''


def generate_jax_module(
    model: SymbolicModel, version: str, with_jacobians: bool = False
) -> str:
    """Render a SymbolicModel as Python source defining
    ``{version}_dynamics(params, x, u, forces) -> x_dot`` and (optionally)
    ``{version}_dynamics_jac -> (x_dot, J_x, J_u)`` with analytic
    state/control Jacobians — the wrenfold ``single_pendulum_dynamics``
    J_x/J_u surface (``single_pendulum_dynamics.hpp:13-16``), emitted as
    CSE'd scalar JAX code so every operation runs on full (batch,)-shaped
    lanes under vmap (no jacfwd tangent axis on every intermediate).
    """
    import sympy as sym
    from sympy.printing.numpy import JaxPrinter

    class _WherePiecewisePrinter(JaxPrinter):
        """Print Piecewise as nested where instead of select (select
        lowers through an argmax; nested where stays elementwise)."""

        def _print_Piecewise(self, expr):
            result = self._print(expr.args[-1].expr)
            for arg in reversed(expr.args[:-1]):
                result = (
                    f"jax.numpy.where({self._print(arg.cond)}, "
                    f"{self._print(arg.expr)}, {result})"
                )
            return result

        def _print_Pow(self, expr, rational=False):
            # Safe sqrt: CSE hoists sqrt(speed^2) out of the Piecewise
            # guard that gates its consumers on speed^2 > 0, so a bare
            # sqrt would propagate inf/NaN *gradients* through both where
            # branches at zero speed even though forward values are fine.
            # Clamping the argument inside the sqrt (the hand-written
            # models/single.py::_safe_speed idiom) keeps the value
            # identical wherever the result is consumed and the gradient
            # finite everywhere.
            if expr.exp == sym.S.Half or expr.exp == -sym.S.Half:
                base = self._print(expr.base)
                root = (
                    f"jax.numpy.sqrt(jax.numpy.where({base} > 0, "
                    f"{base}, 1.0))"
                )
                return root if expr.exp == sym.S.Half else f"(1.0/{root})"
            if expr.exp.is_Integer and expr.exp < 0:
                # Never emit float-exponent pow: ``x**(-1.0)`` lowers to
                # a general ``pow``; a reciprocal of ``integer_pow`` is
                # value-identical and stays elementwise arithmetic.
                base = self.parenthesize(expr.base, 0)
                n = -int(expr.exp)
                denom = base if n == 1 else f"{base}**{n}"
                return f"(1.0/({denom}))"
            return super()._print_Pow(expr, rational=rational)

    printer = _WherePiecewisePrinter()

    def pr(e) -> str:
        # The JaxPrinter spells everything jax.numpy.*; the emitted module
        # imports it as jnp (Max renders as functools.reduce(jnp.maximum, …),
        # hence the functools import in the header).
        return printer.doprint(e).replace("jax.numpy.", "jnp.")

    n_q = len(model.qdd_exprs)
    sd = 2 * n_q
    lines = [_HEADER.format(version=version)]
    lines.append(f"N_Q = {n_q}\n")
    lines.append(f"STATE_DIM = {sd}\n\n")

    param_names = ", ".join(str(s) for s in model.param_syms)
    state_names = ", ".join(str(s) for s in model.state_syms)
    force_names = ", ".join(str(s) for s in model.force_syms)
    n_forces = len(model.force_syms)
    zeros = ", ".join(["0.0"] * n_forces)

    def emit_prologue(fname: str, doc: str):
        lines.append(f"def {fname}(params, x, u, forces=None):\n")
        lines.append(f'    """{doc}\n\n')
        lines.append(
            f"    x = [{state_names}]; params = ({param_names});\n"
            f"    forces = ({force_names}) or None.\"\"\"\n"
        )
        lines.append(f"    {param_names} = params\n")
        for i, s in enumerate(model.state_syms):
            lines.append(f"    {s} = x[{i}]\n")
        lines.append("    if forces is None:\n")
        lines.append(f"        {force_names} = {zeros}\n")
        lines.append("    else:\n")
        for i, s in enumerate(model.force_syms):
            lines.append(f"        {s} = forces[{i}]\n")

    # -- plain dynamics -----------------------------------------------------
    # The `_core` variant returns the state-derivative ROWS as a tuple —
    # the structure-of-arrays form for batch-in-lanes rollouts, where
    # per-coordinate (M,) arrays avoid the stack/index fusion breaks of the
    # packed form. `x` may be a packed (sd, ...) array or a
    # tuple of per-coordinate arrays: only x[i] indexing is used.
    replacements, reduced = sym.cse(list(model.qdd_exprs))
    emit_prologue(
        f"{version}_dynamics_core",
        "Continuous-time dynamics, rows-out: returns the tuple "
        "(qd_0, ..., qdd_0, ...).",
    )
    for lhs, rhs in replacements:
        lines.append(f"    {lhs} = {pr(rhs)}\n")
    for i, e in enumerate(reduced):
        lines.append(f"    qdd_{i} = {pr(e)}\n")
    vel_terms = ", ".join(str(model.state_syms[n_q + i]) for i in range(n_q))
    acc_terms = ", ".join(f"qdd_{i}" for i in range(n_q))
    lines.append(f"    return ({vel_terms}, {acc_terms})\n")
    lines.append("\n\n")
    lines.append(f"def {version}_dynamics(params, x, u, forces=None):\n")
    lines.append('    """Continuous-time x_dot = f(x, u) (packed rows)."""\n')
    lines.append(
        f"    return jnp.stack({version}_dynamics_core(params, x, u, "
        "forces))\n"
    )

    if not with_jacobians:
        return "".join(lines)

    # -- dynamics + analytic Jacobians --------------------------------------
    # Only d(qdd)/d(state, u) needs symbolic differentiation: the qd half
    # of x_dot has constant selector rows.
    exprs = list(model.qdd_exprs)
    for e in model.qdd_exprs:
        for s_ in model.state_syms:
            exprs.append(sym.diff(e, s_))
        exprs.append(sym.diff(e, model.u_sym))
    replacements, reduced = sym.cse(exprs)

    lines.append("\n\n")
    emit_prologue(
        f"{version}_dynamics_jac_core",
        "Rows-out dynamics + analytic Jacobians: returns "
        "(x_dot_rows, J_x_rows, J_u_rows) as nested tuples. Constant "
        "entries are Python literals 0.0/1.0 so downstream chain-rule "
        "products fold away at compile time.",
    )
    for lhs, rhs in replacements:
        lines.append(f"    {lhs} = {pr(rhs)}\n")
    idx = n_q
    for i in range(n_q):
        lines.append(f"    qdd_{i} = {pr(reduced[i])}\n")
    for i in range(n_q):
        for j in range(sd):
            lines.append(f"    dq{i}_x{j} = {pr(reduced[idx])}\n")
            idx += 1
        lines.append(f"    dq{i}_u = {pr(reduced[idx])}\n")
        idx += 1
    lines.append(f"    x_dot = ({vel_terms}, {acc_terms})\n")
    rows = []
    for i in range(n_q):  # qd rows: d(x[n_q+i])/dx = e_{n_q+i}.
        ents = ["1.0" if j == n_q + i else "0.0" for j in range(sd)]
        rows.append("(" + ", ".join(ents) + ")")
    for i in range(n_q):  # qdd rows.
        ents = [f"dq{i}_x{j}" for j in range(sd)]
        rows.append("(" + ", ".join(ents) + ")")
    lines.append("    J_x = (\n")
    for row in rows:
        lines.append(f"        {row},\n")
    lines.append("    )\n")
    ju_ents = ["0.0"] * n_q + [f"dq{i}_u" for i in range(n_q)]
    lines.append("    J_u = (" + ", ".join(ju_ents) + ")\n")
    lines.append("    return x_dot, J_x, J_u\n")

    # Packed wrapper: broadcast constant entries to the batch shape.
    lines.append("\n\n")
    lines.append(f"def {version}_dynamics_jac(params, x, u, forces=None):\n")
    lines.append(
        '    """x_dot = f(x, u) with analytic J_x = df/dx, J_u = df/du '
        '(packed)."""\n'
    )
    lines.append(
        f"    xd, Jx, Ju = {version}_dynamics_jac_core(params, x, u, "
        "forces)\n"
    )
    lines.append("    _zero = x[0] * 0.0\n")
    lines.append("    x_dot = jnp.stack(xd)\n")
    lines.append("    J_x = jnp.stack([\n")
    lines.append(
        "        jnp.stack([e + _zero for e in row]) for row in Jx\n"
    )
    lines.append("    ])\n")
    lines.append("    J_u = jnp.stack([e + _zero for e in Ju])\n")
    lines.append("    return x_dot, J_x, J_u\n")
    return "".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--version", choices=("single", "double", "triple"),
                    default="single")
    ap.add_argument("--jacobians", action="store_true",
                    help="also emit the analytic-Jacobian variant")
    ap.add_argument("--out", default=None,
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)

    derivations = {
        "single": derive_single_cartpole,
        "double": derive_double_cartpole,
        "triple": derive_triple_cartpole,
    }
    model = derivations[args.version]()
    source = generate_jax_module(
        model, args.version, with_jacobians=args.jacobians
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(source)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
