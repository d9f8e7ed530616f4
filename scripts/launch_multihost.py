"""Multi-host scenario-sweep launcher.

Run one copy of this script per host (the reference has no distributed
execution at all — SURVEY.md §2; this is the new-capability path). Pass
--coordinator/--num-processes/--process-id explicitly, or --auto where
the cluster environment lets jax.distributed detect them. Each host
contributes its local devices to one
global scenario mesh; every host feeds its own shard of the global batch
and the psum'd diagnostics are identical on all hosts.

Example (2 hosts):

    host0$ python scripts/launch_multihost.py --coordinator host0:8476 \
               --num-processes 2 --process-id 0 --batch 100000
    host1$ python scripts/launch_multihost.py --coordinator host0:8476 \
               --num-processes 2 --process-id 1 --batch 100000
"""

import argparse
import json
import math
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--auto", action="store_true",
                    help="let jax.distributed auto-detect the cluster "
                    "environment instead of explicit coordinator/process "
                    "arguments")
    ap.add_argument("--batch", type=int, default=8192,
                    help="GLOBAL scenario count (divisible by #devices)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--spacing", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from cartpole_tpu.parallel import initialize_distributed

    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        auto=args.auto,
    )

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cartpole_tpu import OptimizationParams, default_single_params, make_mpc
    from cartpole_tpu.parallel import (
        make_scenario_mesh,
        make_sharded_closed_loop,
        scenario_sharding,
    )

    n_dev = len(jax.devices())
    if args.batch % n_dev:
        raise SystemExit(f"--batch {args.batch} not divisible by {n_dev} devices")

    mpc = make_mpc(OptimizationParams(max_iterations=8,
                                      state_spacing=args.spacing))
    dynamics_params = default_single_params(jnp.float32)
    mesh = make_scenario_mesh()
    sharding = scenario_sharding(mesh)

    # Build the global batch without materializing it on any single host:
    # each process creates only the rows of its addressable shards.
    def make_row(i: int) -> np.ndarray:
        rng = np.random.RandomState(args.seed + i)
        return np.array(
            [
                rng.uniform(-0.5, 0.5),
                -math.pi / 2 + rng.uniform(-0.5, 0.5),
                0.0,
                0.0,
            ],
            np.float32,
        )

    def globalize(shape, per_row):
        return jax.make_array_from_callback(
            shape, sharding,
            lambda idx: np.stack(
                [per_row(i) for i in range(*idx[0].indices(shape[0]))]
            ),
        )

    x0s = globalize((args.batch, 4), make_row)
    set_points = globalize(
        (args.batch,), lambda i: np.zeros((), np.float32)
    )

    run = make_sharded_closed_loop(mpc, mesh, num_steps=args.steps)
    result, diag = run(x0s, dynamics_params, set_points)
    jax.block_until_ready(diag)
    t0 = time.perf_counter()
    result, diag = run(x0s, dynamics_params, set_points)
    # Diagnostics are replicated; pulling them to host syncs the run.
    n_failed = int(diag.n_failed)
    wall = time.perf_counter() - t0

    if jax.process_index() == 0:
        print(json.dumps({
            "hosts": jax.process_count(),
            "devices": n_dev,
            "global_batch": args.batch,
            "steps": args.steps,
            "wall_s": round(wall, 3),
            "solves_per_s": round(args.batch * args.steps / wall, 1),
            "n_failed": n_failed,
            "mean_iterations": float(diag.mean_iterations),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
