"""cartpole_tpu — a batched, accelerator-compiled MPC framework for
cart-pole swing-up.

A ground-up JAX/XLA re-design with the capabilities of the reference C++
stack ``gareth-cross/cart-pole-mpc`` (symbolic-codegen dynamics, RK4
multiple-shooting transcription, constrained nonlinear least-squares MPC,
closed-loop plant simulation, warm starting, diagnostics) — rebuilt as pure
functions over PyTrees so everything jits, vmaps over thousands of scenarios
per chip, and shards over device meshes.

Layer map (bottom-up):
  models/    single / double / triple cart-pole dynamics (analytic + AD Jacobians)
  ops/       mod_pi / RK4 / scan rollouts; batched constrained GN solver
  mpc/       problem builder, controller, plant simulator, closed-loop driver
  parallel/  scenario-sharded meshes, distributed diagnostics
  utils/     structured logging, tracing, checkpointing
"""

from .models import (
    CartPoleModel,
    DOUBLE_CARTPOLE,
    DoubleCartPoleParams,
    SINGLE_CARTPOLE,
    SingleCartPoleParams,
    TRIPLE_CARTPOLE,
    TripleCartPoleParams,
    default_double_params,
    default_single_params,
    default_triple_params,
    double_cartpole_dynamics,
    double_cartpole_energy,
    get_model,
    single_cartpole_dynamics,
    single_cartpole_energy,
    triple_cartpole_dynamics,
    triple_cartpole_energy,
)
from .diff import make_differentiable_solve
from .mpc import (
    ClosedLoopResult,
    MPC,
    MPCOutputs,
    MPCState,
    OptimizationParams,
    Simulator,
    make_mpc,
    run_closed_loop,
    run_closed_loop_lanes,
    run_scheduled_closed_loop,
    simulator_step,
    step_lanes,
)
from .ops import (
    NLSConfig,
    NLSOutputs,
    NLSProblem,
    NLSTerminationState,
    mod_pi,
    rk4_step,
    rollout,
    solve_nls,
    substep_rollout,
    termination_state_name,
)

__version__ = "0.1.0"
