"""Scenario sweep over a (mass, length) parameter grid on a device mesh.

Demonstrates the scale-out capability the reference lacks: thousands of
independent MPC instances with per-scenario plant physics, sharded over
every available device, with psum-reduced health diagnostics and a
checkpointable result.

    python examples/batch_sweep.py --batch 512 --steps 150
"""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import dataclasses
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--checkpoint", default=None,
                    help="save final warm-start states to this .npz")
    ap.add_argument("--lanes", action="store_true",
                    help="run each shard through the batch-in-lanes "
                    "condensed path (mpc/lanes.py) instead of vmap")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    import cartpole_tpu as ct
    from cartpole_tpu.parallel import (
        make_scenario_mesh,
        make_sharded_closed_loop,
        shard_scenarios,
    )

    n = args.batch
    mesh = make_scenario_mesh()
    print(f"{mesh.devices.size} device(s); {n} scenarios")

    # Parameter grid: pole mass x pole length, everything else nominal.
    rng = np.random.RandomState(0)
    base = ct.default_single_params(dtype)
    grid = dataclasses.replace(
        jax.tree.map(lambda v: jnp.broadcast_to(v, (n,)), base),
        m_1=jnp.asarray(rng.uniform(0.05, 0.2, n), dtype),
        l_1=jnp.asarray(rng.uniform(0.15, 0.4, n), dtype),
    )

    x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
    x0s[:, 1] += rng.uniform(-0.3, 0.3, n)

    mpc = ct.make_mpc(
        ct.OptimizationParams(
            state_spacing=5, max_iterations=10, kkt_method="condensed"
        )
    )
    run = make_sharded_closed_loop(
        mpc, mesh, num_steps=args.steps, batched_params=True,
        layout="lanes" if args.lanes else "vmap",
    )

    t0 = time.perf_counter()
    result, diag = run(
        shard_scenarios(jnp.asarray(x0s, dtype), mesh),
        shard_scenarios(grid, mesh),
        shard_scenarios(jnp.zeros((n,), dtype), mesh),
    )
    xf = np.asarray(result.final_state)  # sync
    wall = time.perf_counter() - t0

    upright = np.abs(xf[:, 1] - math.pi / 2) < 1e-2
    print(json.dumps({
        "wall_s": round(wall, 2),
        "solves_per_s": round(n * args.steps / wall, 1),
        "fraction_upright": float(upright.mean()),
        "n_failed_solves": int(diag.n_failed),
        "mean_solver_iterations": round(float(diag.mean_iterations), 2),
    }, indent=2))

    if args.checkpoint:
        from cartpole_tpu.utils import save_state

        save_state(args.checkpoint, result.final_mpc_state)
        print(f"warm-start states saved to {args.checkpoint}")


if __name__ == "__main__":
    main()
