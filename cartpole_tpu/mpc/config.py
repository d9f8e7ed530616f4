"""MPC configuration — the ``OptimizationParams`` analog.

Field-for-field parity with the reference struct
(``/root/reference/optimization/optimization.hpp:12-53``), including the
sign convention: a **negative terminal weight turns that terminal cost into an
equality constraint** (``optimization.cc:236-267``). Two additions: the
decision-variable clamps that the reference hard-codes in its retraction with
a "make parameters for these" TODO (``optimization.cc:319-328``) are real
parameters here, with the same defaults.

The dataclass is frozen/hashable so it can be a jit-static argument; shapes of
the compiled program are derived from it (window_length, state_spacing,
max_iterations), matching the reference behavior of rebuilding the optimizer
when params change (``viz/src/application.ts:367-373``).
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["OptimizationParams"]


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    #: Step between sequential control inputs in the planning window (s).
    control_dt: float = 0.01
    #: Length of the planning horizon in samples.
    window_length: int = 40
    #: Number of control inputs between sequential shooting states.
    #: 1 = multiple shooting; == window_length ~ single shooting.
    state_spacing: int = 10
    #: Max iterations of the NLS optimization.
    max_iterations: int = 8
    relative_exit_tol: float = 1.0e-5
    absolute_first_derivative_tol: float = 1.0e-6
    equality_penalty_initial: float = 1.0
    #: Amplitude of the sinusoidal cold-start control guess.
    u_guess_sinusoid_amplitude: float = 10.0
    #: Quadratic weights on the control inputs.
    u_cost_weight: float = 0.1
    u_derivative_cost_weight: float = 0.1
    #: Terminal-state weights; negative => equality constraint instead.
    b_x_final_cost_weight: float = 150.0
    th_final_cost_weight: float = -1.0
    b_x_dot_final_cost_weight: float = -1.0
    th_dot_final_cost_weight: float = -1.0
    #: Decision-variable clamps applied by the retraction.
    b_x_limit: float = 5.0
    u_limit: float = 300.0
    #: Line-search budget (reference: hard-coded 5, ``optimization.cc:76``).
    max_line_search_iterations: int = 5
    #: KKT linear solver: "condensed" (default — exact elimination of the
    #: defect+pin rows down to a K x K SPD factorization; the fast path),
    #: "schur" (two SPD
    #: Cholesky solves on the augmented system), or "lu" (reference-parity
    #: symmetric-indefinite factorization of the full KKT system). All three
    #: solve the same linear system, i.e. produce identical Gauss-Newton
    #: iterates up to rounding; see ops/solver.py and mpc/problem.py. New
    #: knob, no reference analog.
    kkt_method: str = "condensed"
    #: Use the machine-generated closed-form dynamics Jacobians
    #: (models/_*_gen.py) chained by rule instead of jacfwd for the defect
    #: linearization. Equivalent to <=1e-11; off by default on the vmapped
    #: path (jacfwd shares one primal across all tangents). The lanes path
    #: always uses them.
    analytic_jacobians: bool = False
    #: Re-base the hard terminal equality rows onto an orthonormal basis
    #: (per-instance constraint-space QR of the condensed A_eq block)
    #: before the Schur elimination. The constraint SET — and hence the
    #: exact-arithmetic GN step — is unchanged; only the numerics differ:
    #: the equality part of the Schur factor gets orthonormal columns by
    #: construction, so near-dependent row sets (the double pole's 5
    #: terminal rows across a 0.6 s window, Schur cond ~1e9) no longer
    #: square their conditioning into the f32 solve. Condensed path only.
    #: New knob, no reference analog (the reference never ran its
    #: negative-weight⇒equality mode in f32: optimization.cc:236-267 is
    #: double-precision throughout).
    rebase_equalities: bool = False

    def __post_init__(self):
        if self.control_dt <= 0:
            raise ValueError("control_dt must be > 0")
        if self.window_length < 1:
            raise ValueError("window_length must be >= 1")
        if self.state_spacing < 1:
            raise ValueError("state_spacing must be >= 1")
        if self.window_length % self.state_spacing != 0:
            raise ValueError(
                f"state_spacing ({self.state_spacing}) must divide window_length "
                f"({self.window_length}) cleanly"
            )
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        if self.u_cost_weight < 0 or self.u_derivative_cost_weight < 0:
            raise ValueError("control cost weights must be >= 0")
        # The retraction clamps with jnp.clip(z, -limit, +limit); a negative
        # limit would give min > max and silently pin every variable to the
        # upper bound, so reject it here like the other shape/sign typos.
        # (Negative-means-equality applies to the *final cost weights* only.)
        if self.b_x_limit <= 0 or self.u_limit <= 0:
            raise ValueError("b_x_limit and u_limit must be > 0")
        if self.max_line_search_iterations < 1:
            raise ValueError("max_line_search_iterations must be >= 1")

    @property
    def num_states(self) -> int:
        """Number of shooting states in the window, incl. the terminal one
        (``optimization.hpp:52``)."""
        return self.window_length // self.state_spacing + 1

    # -- JSON round trip (config-surface parity with wasm.cc:23-28) ---------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "OptimizationParams":
        data = json.loads(payload)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"unknown OptimizationParams field(s) {unknown}; "
                f"known fields: {sorted(known)}"
            )
        return cls(**data)

    def replace(self, **kwargs) -> "OptimizationParams":
        return dataclasses.replace(self, **kwargs)
