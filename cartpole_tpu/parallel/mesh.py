"""Device meshes and scenario shardings.

The "communication backend" (SURVEY.md §5): a 1-D mesh over all devices
with the scenario batch sharded along it. Several hosts join via
``jax.distributed.initialize``; XLA routes the collectives (NCCL on GPUs)
over whatever links join the devices, so nothing here is topology
specific.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "SCENARIO_AXIS",
    "initialize_distributed",
    "make_scenario_mesh",
    "scenario_sharding",
    "replicated_sharding",
    "shard_scenarios",
    "host_local_batch",
]

#: Canonical name of the scenario (batch) mesh axis.
SCENARIO_AXIS = "scenarios"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
) -> None:
    """Join a multi-host run (no-op for single-process).

    Thin wrapper over ``jax.distributed.initialize`` so launchers have one
    entry point. Multi-host is OPT-IN: pass explicit arguments, set a
    coordinator env var (``JAX_COORDINATOR_ADDRESS``/``COORDINATOR_ADDRESS``),
    or pass ``auto=True`` to let JAX auto-detect the cluster from its
    environment. With no opt-in signal this returns without initializing,
    so a single-host run never depends on what auto-detection makes of its
    environment. A multi-host launcher MUST therefore pass ``auto=True`` or
    explicit coordinates (``scripts/launch_multihost.py`` does); otherwise
    each host runs as an independent job and "global" psum diagnostics
    silently cover only local scenarios.
    """
    import os

    if num_processes is not None and num_processes <= 1:
        return
    if (
        not auto
        and coordinator_address is None
        and num_processes is None
        and "JAX_COORDINATOR_ADDRESS" not in os.environ
        and "COORDINATOR_ADDRESS" not in os.environ
    ):
        # No multi-host opt-in: run single-process.
        return
    if coordinator_address is None:
        # jax.distributed.initialize only reads JAX_COORDINATOR_ADDRESS;
        # honor the COORDINATOR_ADDRESS spelling this gate accepts rather
        # than falling into cluster auto-detection.
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_scenario_mesh(
    devices: Optional[Sequence[Any]] = None, axis_name: str = SCENARIO_AXIS
) -> Mesh:
    """A 1-D mesh over ``devices`` (default: all global devices).

    MPC scenarios are embarrassingly parallel, so a single flat axis is the
    right topology regardless of how the devices are linked — only the tiny
    diagnostic reductions ever cross it.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis_name,))


def scenario_sharding(mesh: Mesh, axis_name: str = SCENARIO_AXIS) -> NamedSharding:
    """Sharding that splits a leading batch axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that replicates a value on every device of the mesh."""
    return NamedSharding(mesh, P())


def shard_scenarios(tree: Any, mesh: Mesh, axis_name: str = SCENARIO_AXIS) -> Any:
    """Place a PyTree with a leading batch axis scenario-sharded on the mesh.

    Every leaf must have the same leading dimension, divisible by the mesh
    size. Leaves land distributed — no single-device staging of the full
    batch (the 100k-scenario sweeps of BASELINE.json never materialize on
    one host).
    """
    sharding = scenario_sharding(mesh, axis_name)
    return jax.tree.map(lambda leaf: jax.device_put(leaf, sharding), tree)


def host_local_batch(global_batch: int, mesh: Mesh) -> int:
    """Scenarios per device for an evenly divisible global batch."""
    n = mesh.devices.size
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by mesh size {n}"
        )
    return global_batch // n
