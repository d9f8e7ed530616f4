"""Probe: lanes-path throughput with PER-INSTANCE dynamics params.

BASELINE config #5 is a 100k-scenario (mass, length)-GRID sweep. Per-
instance params ride the lane axis as ``(B,)`` leaves, which forfeits the
constant folding the bench gets from scalar params closed over as
constants. This probe measures that cost at the bench operating point.
Writes ``params_grid.json``.
"""

import argparse
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
    "params_grid.json",
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from cartpole_tpu import (
        OptimizationParams, default_single_params, make_mpc,
    )
    from cartpole_tpu.mpc.lanes import run_closed_loop_lanes
    from cartpole_tpu.utils.device import device_record, enable_compile_cache

    enable_compile_cache()

    dtype = jnp.float32
    n, ticks = args.batch, args.ticks
    mpc = make_mpc(OptimizationParams(
        max_iterations=8, state_spacing=5, kkt_method="condensed"))
    base = default_single_params(dtype)
    rng = np.random.RandomState(0)
    # The (mass, length) grid over the UI slider ranges, tiled up to the
    # batch when side*side < n (non-square batches must still fill every
    # instance: each leaf needs one value per lane).
    side = max(int(math.sqrt(n)), 1)
    masses = np.linspace(0.05, 0.2, side)
    lengths = np.linspace(0.15, 0.4, side)
    mm, ll = np.meshgrid(masses, lengths)
    m_flat = np.resize(mm.reshape(-1), n)
    l_flat = np.resize(ll.reshape(-1), n)
    grid = dataclasses.replace(
        base,
        m_1=jnp.asarray(m_flat, dtype),
        l_1=jnp.asarray(l_flat, dtype),
    )
    x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
    x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
    x0s = jnp.asarray(x0s, dtype)
    sps = jnp.zeros((n,), dtype)

    results = {
        **device_record(),
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "batch": n, "ticks": ticks,
        "grid": f"{side}x{side} (m_1 0.05-0.2, l_1 0.15-0.4)",
    }

    def save():
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)

    def timed(name, dp):
        run = jax.jit(lambda x, s: run_closed_loop_lanes(
            mpc, x, dp, ticks, s))
        print(f"[{name}] compiling ...", flush=True)
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(x0s, sps))
        compile_s = time.perf_counter() - t0
        best = math.inf
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = jax.block_until_ready(run(x0s, sps))
            best = min(best, time.perf_counter() - t0)
        term = np.asarray(res.termination_states)
        row = {
            "compile_s": round(compile_s, 1),
            "solves_per_s": round(n * ticks / best, 1),
            "ms_per_tick": round(best / ticks * 1e3, 3),
            "n_failed": int(np.sum((term == 3) | (term == 4))),
        }
        results[name] = row
        print(f"[{name}]", json.dumps(row), flush=True)
        save()
        return row

    r_scalar = timed("scalar_params", base)
    r_grid = timed("grid_params", grid)
    results["summary"] = {
        "grid_vs_scalar": round(
            r_grid["solves_per_s"] / r_scalar["solves_per_s"], 4),
        "note": (
            "grid_vs_scalar is the cost of per-instance (B,) param leaves "
            "against scalar params folded into the program as constants."
        ),
    }
    save()
    print(json.dumps(results["summary"], indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
