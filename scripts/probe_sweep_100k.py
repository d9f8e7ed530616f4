"""Probe: the BASELINE config-#5 sweep at 100k scale.

``BASELINE.json`` config #5 is a "100k scenarios x (mass, length,
horizon) grid" sweep. This probe runs it at full scale on the devices JAX
sees: 98,304 scenarios with per-instance (mass, length) params through
the scenario-sharded lanes path (``parallel/sharded.py``,
``layout="lanes"``), once per horizon point — the horizon axis of the
grid is a compile-time shape, so a deployment runs one program per
horizon value exactly like this. Writes ``sweep_100k.json``.
"""

import dataclasses
import json
import math
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax
import jax.numpy as jnp
import numpy as np

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "sweep_100k.json",
)


def main():
    from cartpole_tpu import (
        OptimizationParams, default_single_params, make_mpc,
    )
    from cartpole_tpu.parallel import (
        make_scenario_mesh, make_sharded_closed_loop, shard_scenarios,
    )
    from cartpole_tpu.utils.device import device_record, enable_compile_cache

    enable_compile_cache()

    dtype = jnp.float32
    n = 192 * 512  # 98,304 scenarios
    ticks = 50
    reps = 2
    mesh = make_scenario_mesh()
    rng = np.random.RandomState(0)
    base = default_single_params(dtype)
    side = 314  # 314^2 = 98,596 >= n: full-resolution grid
    mm, ll = np.meshgrid(
        np.linspace(0.05, 0.2, side), np.linspace(0.15, 0.4, side)
    )
    grid = dataclasses.replace(
        jax.tree.map(lambda v: jnp.broadcast_to(v, (n,)), base),
        m_1=jnp.asarray(mm.reshape(-1)[:n], dtype),
        l_1=jnp.asarray(ll.reshape(-1)[:n], dtype),
    )
    x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
    x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
    x0s = shard_scenarios(jnp.asarray(x0s, dtype), mesh)
    sps = shard_scenarios(jnp.zeros((n,), dtype), mesh)
    grid = shard_scenarios(grid, mesh)

    results = {
        **device_record(),
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "scenarios": n, "ticks": ticks,
        "grid": f"(m_1 x l_1) {side}x{side} truncated to {n}",
        "horizons": [],
    }

    def save():
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)

    for window in (40, 60):
        mpc = make_mpc(OptimizationParams(
            max_iterations=8, state_spacing=5, kkt_method="condensed",
            window_length=window,
        ))
        run = make_sharded_closed_loop(
            mpc, mesh, num_steps=ticks, batched_params=True,
            layout="lanes",
        )
        print(f"[K={window}] compiling ...", flush=True)
        t0 = time.perf_counter()
        result, diag = jax.block_until_ready(run(x0s, grid, sps))
        compile_s = time.perf_counter() - t0
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            result, diag = jax.block_until_ready(run(x0s, grid, sps))
            best = min(best, time.perf_counter() - t0)
        row = {
            "window_length": window,
            "compile_s": round(compile_s, 1),
            "solves_per_s": round(n * ticks / best, 1),
            "ms_per_tick": round(best / ticks * 1e3, 3),
            "n_failed": int(diag.n_failed),
            "mean_iterations": round(float(diag.mean_iterations), 2),
        }
        results["horizons"].append(row)
        print(f"[K={window}]", json.dumps(row), flush=True)
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
