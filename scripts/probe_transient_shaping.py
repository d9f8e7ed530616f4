"""Probe: PREVENT double-pole knockdowns during the cold-start transient.

Round 3 characterized the bench regime's residual ~0.76% stuck set as
high-energy tumbling created during the first ~50 cold-start ticks
(0.245 upright @50 → 0.9785 @250; `knockdowns.json`) and proved recovery
from it quantifiably infeasible (`knockdown_reachability.json`). Every
round-3 intervention was post-hoc. This probe (VERDICT r3 item 5) tests
whether SHAPING THE TRANSIENT prevents entry into the tumbling set:

- ``rate``:   4x u_derivative_cost_weight for the first phase (rate-limit
              the slam that dumps energy into the chain);
- ``damp``:   4x terminal velocity weights for the first phase;
- ``softu``:  u_limit 120 instead of 300 for the first phase;
- ``combo``:  rate + softu;
- baseline:   the bench configuration end to end.

Phase A = first 50 ticks (the transient window), then the bench config
continues to 250 ticks with the warm-start state carried across the
config switch (same spec dim, so ``previous_solution`` transfers).
Metrics per variant: upright fraction @50/@250, n_failed, and the count
of instances down at 250 that were also down at 50 (the transient's
signature). Batch 4096, f32, lanes path (the product path).

Writes ``transient_shaping.json``.
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

from cartpole_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "transient_shaping.json",
)

BENCH_KW = dict(
    max_iterations=8, state_spacing=5, kkt_method="condensed",
    window_length=60,
    th_final_cost_weight=150.0,
    th_dot_final_cost_weight=10.0,
    b_x_dot_final_cost_weight=10.0,
    u_guess_sinusoid_amplitude=0.0,
)

VARIANTS = {
    "baseline": {},
    "rate": dict(u_derivative_cost_weight=0.4),
    "damp": dict(th_dot_final_cost_weight=40.0,
                 b_x_dot_final_cost_weight=40.0),
    "softu": dict(u_limit=120.0),
    "combo": dict(u_derivative_cost_weight=0.4, u_limit=120.0),
    # Round-2 sweep after "rate" won round 1 (45 vs 76 knockdowns):
    "rate2": dict(u_derivative_cost_weight=0.2),
    "rate8": dict(u_derivative_cost_weight=0.8),
    "rate_flat": dict(_flat=True, u_derivative_cost_weight=0.4),
    "rate_a100": dict(_phase_a=100, u_derivative_cost_weight=0.4),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--phase-a", type=int, default=50)
    ap.add_argument("--total", type=int, default=250)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from cartpole_tpu import OptimizationParams, get_model, make_mpc
    from cartpole_tpu.mpc.lanes import run_closed_loop_lanes

    dtype = jnp.float32
    model = get_model("double")
    dp = jax.tree.map(lambda v: jnp.asarray(v, dtype),
                      model.default_params())
    n = args.batch
    rng = np.random.RandomState(args.seed)
    up = math.pi / 2
    x0s = np.tile(np.array([0.0, up, up, 0.0, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
    x0s[:, 1] += rng.uniform(-0.15, 0.15, n)
    x0s[:, 2] += rng.uniform(-0.1, 0.1, n)
    x0s = jnp.asarray(x0s, dtype)
    sps = jnp.zeros((n,), dtype)

    def upright_mask(xf):
        # xf: (B, sd) batch-first final_state; bench's 0.1 rad criterion
        # on both link angles (bench.py::_upright_fraction).
        th = np.asarray(xf)[:, [1, 2]]
        return np.all(
            np.abs(np.mod(th - up + math.pi, 2 * math.pi) - math.pi) < 0.1,
            axis=1,
        )

    def runner(kw):
        mpc = make_mpc(OptimizationParams(**kw), model)
        return mpc, jax.jit(lambda x, st: run_closed_loop_lanes(
            mpc, x, dp, args.chunk, sps, mpc_state=st,
        ))

    results = {"batch": n, "phase_a": args.phase_a, "total": args.total, "seed": args.seed}
    mpc_bench, run_bench = runner(BENCH_KW)
    for name in args.variants.split(","):
        vkw = dict(VARIANTS[name])
        flat = vkw.pop("_flat", False)
        phase_a = vkw.pop("_phase_a", args.phase_a)
        kw = dict(BENCH_KW, **vkw)
        t0 = time.time()
        if vkw:
            _, run_a = runner(kw)
        else:
            run_a = run_bench
        run_b = run_a if flat else run_bench
        x = x0s
        st = None
        n_failed = 0
        up50 = None
        ticks = 0
        while ticks < args.total:
            run = run_a if ticks < phase_a else run_b
            res = run(x, st) if st is not None else run(x, None)
            x = res.final_state  # (B, sd), next chunk's x0
            st = res.final_mpc_state
            term = np.asarray(res.termination_states)
            n_failed += int(np.sum((term == 3) | (term == 4)))
            ticks += args.chunk
            if ticks == args.chunk:
                up50 = upright_mask(res.final_state)
        up250 = upright_mask(res.final_state)
        down250 = ~up250
        row = {
            "frac_upright_50": round(float(np.mean(up50)), 4),
            "frac_upright_250": round(float(np.mean(up250)), 4),
            "n_down_250": int(np.sum(down250)),
            "n_down_250_also_down_50": int(np.sum(down250 & ~up50)),
            "n_failed": n_failed,
            "wall_s": round(time.time() - t0, 1),
        }
        results[name] = row
        print(name, json.dumps(row), flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
