"""Scenario-parallel execution over device meshes.

The reference runs ONE MPC instance on one browser/CPU thread (SURVEY.md §2
parallelism audit: no threads, no distributed backend anywhere). This
subsystem is therefore new first-class capability, designed for devices:

* **batch axis** — thousands of independent MPC instances per device via
  ``vmap`` (the data-parallel analog);
* **mesh axis** — scenarios sharded across devices/hosts with ``shard_map``
  over a ``jax.sharding.Mesh``; XLA collectives (NCCL on GPUs) carry only the
  tiny ``psum``/``pmax`` diagnostic reductions, since MPC instances are
  embarrassingly parallel (zero cross-instance communication in the solve).
"""

from .mesh import (
    host_local_batch,
    initialize_distributed,
    make_scenario_mesh,
    replicated_sharding,
    scenario_sharding,
    shard_scenarios,
)
from .sharded import (
    BatchDiagnostics,
    make_sharded_closed_loop,
    make_sharded_step,
    reduce_diagnostics,
)

__all__ = [
    "BatchDiagnostics",
    "host_local_batch",
    "initialize_distributed",
    "make_scenario_mesh",
    "make_sharded_closed_loop",
    "make_sharded_step",
    "reduce_diagnostics",
    "replicated_sharding",
    "scenario_sharding",
    "shard_scenarios",
]
