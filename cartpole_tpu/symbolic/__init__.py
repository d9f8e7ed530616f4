"""Symbolic derivation & verification of the cart-pole model families.

The reference derives its dynamics symbolically (SymPy/wrenfold Lagrangian,
``/root/reference/symbolic/dynamics_single.py``, ``dynamics_double.py``) and
code-generates C++ (``symbolic/generate.py``). This framework's dynamics
are hand-written closed-form JAX (Jacobians via AD), so this layer inverts
the role: the SymPy derivation is kept as an **independent correctness
oracle** — the Euler-Lagrange equations are derived from scratch here and
lambdified, and tests assert the JAX models match them to near machine
precision. ``generate`` can also emit a JAX module from the derivation (the
``python -m symbolic.generate`` analog) for new model families.
"""

from .lagrangian import (
    derive_double_cartpole,
    derive_single_cartpole,
    make_numeric_double,
    make_numeric_single,
)

__all__ = [
    "derive_double_cartpole",
    "derive_single_cartpole",
    "make_numeric_double",
    "make_numeric_single",
]
