"""Drop-in ``pypendulum`` compatibility layer.

The reference ships a nanobind module ``pypendulum`` built from
``wrapper/wrapper.cc:40-103`` (classes ``SingleCartPoleParams``,
``OptimizationParams``, ``SingleCartPoleState``, ``OptimizationOutputs``,
``Optimization``, ``Vector2``, ``Simulator``). This module mirrors that
surface *exactly* — mutable field-by-field structs, the same constructor
signatures and argument orders, the same method names — so scripts written
against the reference (e.g. ``model/scratch.py:22-77``) run unchanged on
the JAX stack:

    import cartpole_tpu.pypendulum as pypendulum

After that import (or ``from cartpole_tpu import pypendulum``), a plain
``import pypendulum`` also resolves here via a ``sys.modules`` alias.

Precision: the reference is C++ ``double``; this shim solves in float64
when ``jax_enable_x64`` is on (the parity configuration) and float32
otherwise (the deployment dtype — every closed-loop threshold still
holds there, see ``tests/test_f32_robustness.py``). The solver runs the
``lu`` reference-parity KKT path by default (see :class:`Optimization`).

Semantics preserved from the nanobind wrapper:

* ``Optimization(params)`` snapshots the params at construction — later
  mutation of the params object does not affect an existing instance
  (``optimization.cc:303-330`` builds the solver on first use).
* ``Optimization.step(state, dynamics_params, b_x_set_point)`` carries the
  warm start internally across calls (``optimization.hpp:107``).
* ``set_previous_solution(guess)`` seeds the next solve
  (``optimization.hpp:86-89``); ``reset()`` discards it
  (``optimization.hpp:83`` — exposed by the WASM binding).
* ``Simulator`` starts at the hanging state ``{0, -pi/2, 0, 0}``
  (``simulator.hpp:28``) and integrates with 1 ms substeps.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .models import params as _params
from .mpc import simulator as _simulator
from .mpc.config import OptimizationParams as _FrozenOptimizationParams
from .mpc.controller import MPC as _MPC
from .utils.logging import solver_summary as _solver_summary

__all__ = [
    "SingleCartPoleParams",
    "SingleCartPoleState",
    "OptimizationParams",
    "OptimizationOutputs",
    "Optimization",
    "Vector2",
    "Simulator",
]

_DYNAMICS_FIELDS = (
    "m_b", "m_1", "l_1", "g", "mu_b", "v_mu_b", "c_d_1", "x_s", "k_s",
)

#: The reference OptimizationParams surface (``wrapper.cc:57-72``), with the
#: defaults of ``optimization.hpp:12-53``.
_OPT_FIELDS = (
    "control_dt", "window_length", "state_spacing", "max_iterations",
    "relative_exit_tol", "absolute_first_derivative_tol",
    "equality_penalty_initial", "u_guess_sinusoid_amplitude",
    "u_cost_weight", "u_derivative_cost_weight",
    "b_x_final_cost_weight", "th_final_cost_weight",
    "b_x_dot_final_cost_weight", "th_dot_final_cost_weight",
)


def _dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class SingleCartPoleParams:
    """Mutable mirror of ``pendulum::SingleCartPoleParams``
    (``structs.hpp:8-41``; binding ``wrapper.cc:41-54``). Constructor takes
    the 9 parameters positionally in the reference order."""

    def __init__(self, m_b=1.0, m_1=0.1, l_1=0.25, g=9.81, mu_b=0.03,
                 v_mu_b=0.1, c_d_1=0.13, x_s=0.8, k_s=100.0):
        (self.m_b, self.m_1, self.l_1, self.g, self.mu_b, self.v_mu_b,
         self.c_d_1, self.x_s, self.k_s) = (
            m_b, m_1, l_1, g, mu_b, v_mu_b, c_d_1, x_s, k_s)

    def _frozen(self, dtype):
        return _params.SingleCartPoleParams(**{
            k: jnp.asarray(float(getattr(self, k)), dtype)
            for k in _DYNAMICS_FIELDS
        })

    def __repr__(self):
        inner = ", ".join(
            f"{k}={getattr(self, k)!r}" for k in _DYNAMICS_FIELDS)
        return f"SingleCartPoleParams({inner})"


class SingleCartPoleState:
    """Mutable mirror of ``pendulum::SingleCartPoleState``
    (``structs.hpp:44-64``): fields/ctor order ``(b_x, th_1, b_x_dot,
    th_1_dot)``."""

    def __init__(self, b_x=0.0, th_1=0.0, b_x_dot=0.0, th_1_dot=0.0):
        self.b_x, self.th_1 = float(b_x), float(th_1)
        self.b_x_dot, self.th_1_dot = float(b_x_dot), float(th_1_dot)

    def to_vector(self):
        """``ToVector()`` analog — ndarray ``[b_x, th_1, b_x_dot, th_1_dot]``."""
        return np.array([self.b_x, self.th_1, self.b_x_dot, self.th_1_dot])

    @classmethod
    def _from_array(cls, x):
        x = np.asarray(x, dtype=float)
        return cls(x[0], x[1], x[2], x[3])

    def __repr__(self):
        return (f"SingleCartPoleState(b_x={self.b_x!r}, th_1={self.th_1!r}, "
                f"b_x_dot={self.b_x_dot!r}, th_1_dot={self.th_1_dot!r})")


class OptimizationParams:
    """Mutable mirror of ``pendulum::OptimizationParams``
    (``optimization.hpp:12-53``; binding ``wrapper.cc:57-72``)."""

    def __init__(self, **kwargs):
        defaults = _FrozenOptimizationParams()
        for k in _OPT_FIELDS:
            setattr(self, k, getattr(defaults, k))
        for k, v in kwargs.items():
            if k not in _OPT_FIELDS:
                raise TypeError(f"unknown OptimizationParams field: {k}")
            setattr(self, k, v)

    def _frozen(self) -> _FrozenOptimizationParams:
        return _FrozenOptimizationParams(**{
            k: (int(getattr(self, k))
                if k in ("window_length", "state_spacing", "max_iterations")
                else float(getattr(self, k)))
            for k in _OPT_FIELDS
        })

    def __repr__(self):
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in _OPT_FIELDS)
        return f"OptimizationParams({inner})"


class OptimizationOutputs:
    """Mirror of ``pendulum::OptimizationOutputs`` (``optimization.hpp:55-70``;
    binding ``wrapper.cc:81-85``). ``u`` is a list of floats,
    ``predicted_states`` a list of :class:`SingleCartPoleState`."""

    def __init__(self, outputs):
        self._outputs = outputs  # the underlying MPCOutputs PyTree
        self.initial_state = SingleCartPoleState._from_array(
            np.asarray(outputs.initial_state))
        self.previous_solution = [
            float(v) for v in np.asarray(outputs.previous_solution)]
        self.u = [float(v) for v in np.asarray(outputs.u)]
        self.predicted_states = [
            SingleCartPoleState._from_array(row)
            for row in np.asarray(outputs.predicted_states)
        ]

    def solver_summary(self) -> str:
        """``NLSSolverOutputs.ToString()`` analog (``wrapper.cc:82-83``)."""
        return _solver_summary(self._outputs.solver)


class Optimization:
    """Mirror of ``pendulum::Optimization`` (``optimization.hpp:73-108``;
    binding ``wrapper.cc:87-90``): a stateful object carrying the warm
    start across ``step`` calls.

    The shim defaults to the ``lu`` KKT path — the reference-parity
    factorization (our u(t) agrees with the independent C++ oracle to
    2.8e-5 on it, ``tests/test_native.py``). The package-wide default is
    the ``condensed`` fast path, whose (exact) re-factorization shifts
    iterates by ~1e-4/step, which closed-loop chaos amplifies; pass
    ``kkt_method="condensed"`` here to opt in when throughput matters more
    than trajectory-identity."""

    def __init__(self, params: OptimizationParams, kkt_method: str = "lu"):
        self._dtype = _dtype()
        self._mpc = _MPC(params._frozen().replace(kkt_method=kkt_method))
        self._state = self._mpc.init_state(self._dtype)
        self._jit_step = jax.jit(self._mpc.step)

    def step(self, current_state: SingleCartPoleState,
             dynamics_params: SingleCartPoleParams,
             b_x_set_point: float = 0.0) -> OptimizationOutputs:
        x0 = jnp.asarray(current_state.to_vector(), self._dtype)
        dp = dynamics_params._frozen(self._dtype)
        outputs, self._state = self._jit_step(
            self._state, x0, dp, jnp.asarray(b_x_set_point, self._dtype))
        return OptimizationOutputs(outputs)

    def reset(self) -> None:
        """Discard the warm start (``optimization.hpp:83``)."""
        self._state = self._mpc.reset(self._state)

    def set_previous_solution(self, guess: Sequence[float]) -> None:
        guess = jnp.asarray(np.asarray(guess, dtype=float), self._dtype)
        if guess.shape != (self._mpc.spec.dim,):
            raise ValueError(
                f"guess must have {self._mpc.spec.dim} entries, "
                f"got {guess.shape}")
        self._state = self._mpc.set_previous_solution(self._state, guess)


class Vector2:
    """Mirror of ``pendulum::Vector2`` (``structs.hpp:67-70``)."""

    def __init__(self, x=0.0, y=0.0):
        self.x, self.y = float(x), float(y)

    def __repr__(self):
        return f"Vector2({self.x!r}, {self.y!r})"


class Simulator:
    """Mirror of ``pendulum::Simulator`` (``simulator.hpp:10-29``; binding
    ``wrapper.cc:94-97``): 1 kHz substeps, angle wrap, external forces."""

    def __init__(self):
        self._sim = _simulator.Simulator(dtype=_dtype())

    def step(self, params: SingleCartPoleParams, dt: float, u: float,
             f_base: Optional[Vector2] = None,
             f_mass: Optional[Vector2] = None) -> None:
        dtype = self._sim.get_state().dtype
        fb = jnp.asarray(
            [f_base.x, f_base.y] if f_base is not None else [0.0, 0.0], dtype)
        fm = jnp.asarray(
            [f_mass.x, f_mass.y] if f_mass is not None else [0.0, 0.0], dtype)
        self._sim.step(params._frozen(dtype), float(dt),
                       jnp.asarray(float(u), dtype), f_base=fb, f_mass=fm)

    def get_state(self) -> SingleCartPoleState:
        return SingleCartPoleState._from_array(np.asarray(self._sim.get_state()))

    def set_state(self, state: SingleCartPoleState) -> None:
        """``SetState`` analog (``simulator.hpp:24``)."""
        self._sim.set_state(jnp.asarray(
            state.to_vector(), self._sim.get_state().dtype))


# ``import pypendulum`` resolves here once this module has been imported —
# the switching cost for a reference user is one import line (or a
# one-liner ``sys.modules`` alias before their unmodified script).
sys.modules.setdefault("pypendulum", sys.modules[__name__])
