"""Probe: the algorithmic levers of the solve.

Two throughput dimensions are algorithmic: GN iteration count (8,
reference default) and folded line-search trial count (5, hard-coded in
the reference, ``optimization.cc:76``). Each trial re-rolls the whole
window once per iteration. This probe measures
throughput AND closed-loop health (300-tick swing-up fraction, failed
solves) for (iters, trials) variants at the bench operating point.
These are SEMANTICS-CHANGING knobs — the probe records whether the
cheaper solver still clears the health bar, it does not change defaults.
Writes ``algo_levers.json``.
"""

import argparse
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
    "algo_levers.json",
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="8x5,8x4,8x3,6x5,6x4")
    args = ap.parse_args()

    from cartpole_tpu import (
        OptimizationParams, default_single_params, make_mpc,
    )
    from cartpole_tpu.mpc.lanes import run_closed_loop_lanes
    from cartpole_tpu.utils.device import device_record, enable_compile_cache

    enable_compile_cache()

    dtype = jnp.float32
    dp = default_single_params(dtype)
    n, ticks = args.batch, args.ticks
    rng = np.random.RandomState(0)
    x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
    x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
    x0s = jnp.asarray(x0s, dtype)
    sps = jnp.zeros((n,), dtype)

    results = {
        **device_record(),
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "batch": n, "ticks": ticks,
        "rows": [],
    }

    def save():
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)

    def upright(x):
        th = np.asarray(x)[:, 1]
        return float(np.mean(np.abs(
            np.mod(th - math.pi / 2 + math.pi, 2 * math.pi) - math.pi
        ) < 0.1))

    for variant in args.variants.split(","):
        iters, trials = (int(v) for v in variant.split("x"))
        from cartpole_tpu import MPCState

        mpc = make_mpc(OptimizationParams(
            max_iterations=iters, max_line_search_iterations=trials,
            state_spacing=5, kkt_method="condensed",
        ))
        run = jax.jit(lambda x, s, st, m=mpc: run_closed_loop_lanes(
            m, x, dp, ticks, s, mpc_state=st))
        st0 = MPCState(
            previous_solution=jnp.zeros((n, mpc.spec.dim), dtype),
            warm=jnp.zeros((n,), bool),
        )
        print(f"[{variant}] compiling ...", flush=True)
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(x0s, sps, st0))
        compile_s = time.perf_counter() - t0
        best = math.inf
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = jax.block_until_ready(run(x0s, sps, st0))
            best = min(best, time.perf_counter() - t0)
        # 300-tick outcome at the operating point (chunked continuation
        # of the SAME compiled program, warm state carried).
        x, st = res.final_state, res.final_mpc_state
        term = np.asarray(res.termination_states)
        n_failed = int(np.sum((term == 3) | (term == 4)))
        ticks_run = ticks
        while ticks_run < 300:
            res_c = run(x, sps, st)
            x, st = res_c.final_state, res_c.final_mpc_state
            term = np.asarray(res_c.termination_states)
            n_failed += int(np.sum((term == 3) | (term == 4)))
            ticks_run += ticks
        row = {
            "iterations": iters, "trials": trials,
            "compile_s": round(compile_s, 1),
            "solves_per_s": round(n * ticks / best, 1),
            "ms_per_tick": round(best / ticks * 1e3, 3),
            "n_failed_300": n_failed,
            "fraction_upright_300": upright(x),
        }
        results["rows"].append(row)
        print(f"[{variant}]", json.dumps(row), flush=True)
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
