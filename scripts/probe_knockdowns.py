"""Characterize and attack the double-pole bench's residual knockdowns
(VERDICT r2 item 2b).

The double-pole disturbance-rejection bench regime (all-soft terminal
costs, zero-sinusoid cold start, u_limit 300, f32, batch 4096) measured
fraction_upright 0.978@250 -> 0.992@500 in round 2: a cold-start
transient knocks ~2% of instances over; most self-recover slowly, ~1%
stay down. This probe:

  1. reproduces the 500-tick run in 50-tick chunks, recording the
     per-chunk upright fraction (the recovery curve);
  2. classifies instances: never-down / down-at-250-but-recovered /
     down-at-500 (stuck);
  3. continuation experiments on the SAME compiled program from the
     500-tick state: control (no intervention) vs a warm-start KICK —
     overwriting the stuck instances' previous solution with a swing-up
     sinusoid (amplitude sweep) — measuring recovered fraction after 250
     more ticks.

The kick experiment is the mechanism test for a per-instance two-phase
recovery schedule (detector + reset-with-kick on the existing
failure_mask/reset_where machinery). If no amplitude recovers the stuck
set, that is the quantified infeasibility evidence (re-swing-up at
u_limit 300 from knocked-down states is out of reach for the
controller).

Usage: python scripts/probe_knockdowns.py [--batch 4096] [--json out]
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

UP = math.pi / 2
TICKS_PER_CHUNK = 50  # ticks per compiled program


def _bench_double_mpc():
    """EXACTLY bench.py's double-pole configuration — imported from
    bench.py so the probe can never desynchronize from the regime the
    bench actually runs (and shares its compile cache entry)."""
    from bench import DOUBLE_SOFT_OPT_KWARGS
    from cartpole_tpu import OptimizationParams, get_model, make_mpc

    return make_mpc(
        OptimizationParams(
            max_iterations=8,
            state_spacing=5,
            kkt_method="condensed",
            **DOUBLE_SOFT_OPT_KWARGS,
        ),
        get_model("double"),
    )


def _bench_x0s(n, dtype, seed=0):
    from bench import make_x0s

    return make_x0s("double", n, dtype, seed)


def _upright_mask(xf):
    th = np.asarray(xf)[:, 1:3]
    return np.all(
        np.abs(np.mod(th - UP + math.pi, 2 * math.pi) - math.pi) < 0.1,
        axis=1,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--total-ticks", type=int, default=500)
    ap.add_argument("--extra-ticks", type=int, default=250,
                    help="continuation length for the experiments")
    ap.add_argument("--amps", type=float, nargs="*",
                    default=[50.0, 150.0, 300.0])
    ap.add_argument("--json", default="knockdowns.json")
    args = ap.parse_args()

    from cartpole_tpu import MPCState
    from cartpole_tpu.mpc.lanes import run_closed_loop_lanes

    dtype = jnp.float32
    B = args.batch
    mpc = _bench_double_mpc()
    from cartpole_tpu import get_model
    dp = jax.tree.map(lambda v: jnp.asarray(v, dtype),
                      get_model("double").default_params())
    sps = jnp.zeros((B,), dtype)

    run = jax.jit(
        lambda x, s, st: run_closed_loop_lanes(
            mpc, x, dp, TICKS_PER_CHUNK, s, mpc_state=st
        )
    )

    # ---- 1) base 500-tick run, chunked --------------------------------
    x = _bench_x0s(B, dtype)
    st = MPCState(
        previous_solution=jnp.zeros((B, mpc.spec.dim), dtype),
        warm=jnp.zeros((B,), bool),
    )
    curve = []
    masks = {}
    t0 = time.time()
    ticks = 0
    n_failed = 0
    while ticks < args.total_ticks:
        res = run(x, sps, st)
        x, st = res.final_state, res.final_mpc_state
        ticks += TICKS_PER_CHUNK
        m = _upright_mask(x)
        term = np.asarray(res.termination_states)
        n_failed += int(np.sum((term == 3) | (term == 4)))
        curve.append({"tick": ticks, "fraction_upright": float(m.mean())})
        masks[ticks] = m
        print(f"tick {ticks:4d}: upright {m.mean():.4f}", flush=True)
    print(f"base run {time.time()-t0:.0f}s, failed solves {n_failed}")

    # The knockdown census compares an intermediate snapshot (250 ticks,
    # the bench's upright-fraction point) against the final one; fall back
    # to the midpoint chunk when --total-ticks < 250.
    mid = 250 if 250 in masks else min(
        masks, key=lambda t: abs(t - args.total_ticks // 2))
    if mid != 250:
        print(f"note: --total-ticks {args.total_ticks} < 250; using the "
              f"tick-{mid} snapshot for the census")
    down250 = ~masks[mid]
    final_tick = ticks  # last chunk boundary (>= --total-ticks)
    down500 = ~masks[final_tick]
    recovered = down250 & masks[final_tick]
    print(f"down@{mid} {down250.sum()}  down@{final_tick} "
          f"{down500.sum()}  self-recovered {recovered.sum()}")

    # stuck-set state snapshot for the record
    xs_stuck = np.asarray(x)[down500]

    # ---- 2) control continuation --------------------------------------
    def continue_run(x0_, st_, n_ticks):
        xc, stc = x0_, st_
        for _ in range(n_ticks // TICKS_PER_CHUNK):
            resc = run(xc, sps, stc)
            xc, stc = resc.final_state, resc.final_mpc_state
        return xc

    x_ctrl = continue_run(x, st, args.extra_ticks)
    m_ctrl = _upright_mask(x_ctrl)
    ctrl_rec = int((m_ctrl & down500).sum())
    print(f"control +{args.extra_ticks}: stuck recovered "
          f"{ctrl_rec}/{down500.sum()}  overall {m_ctrl.mean():.4f}")

    # ---- 3) kick experiments -------------------------------------------
    K = mpc.spec.window_length
    u_start = mpc.spec.u_start
    k = np.arange(K)
    results = {"curve": curve, "n_failed_base": n_failed,
               "down_250": int(down250.sum()),
               "down_final": int(down500.sum()),
               "self_recovered_250_to_final": int(recovered.sum()),
               "control_recovered": ctrl_rec,
               "stuck_states": xs_stuck.tolist()}
    prev = np.asarray(st.previous_solution)
    for amp in args.amps:
        prev_k = prev.copy()
        kick = amp * np.sin(k / K * 2.0 * math.pi)
        prev_k[down500, u_start:] = kick[None, :]
        st_k = MPCState(
            previous_solution=jnp.asarray(prev_k, dtype),
            warm=jnp.ones((B,), bool),
        )
        x_k = continue_run(x, st_k, args.extra_ticks)
        m_k = _upright_mask(x_k)
        rec = int((m_k & down500).sum())
        knocked = int((~m_k & masks[final_tick]).sum())
        results[f"kick_{amp:g}_recovered"] = rec
        results[f"kick_{amp:g}_collateral_knockdowns"] = knocked
        print(f"kick amp {amp:5g} +{args.extra_ticks}: stuck recovered "
              f"{rec}/{down500.sum()}  collateral {knocked}  "
              f"overall {m_k.mean():.4f}", flush=True)

    with open(args.json, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.json}")


if __name__ == "__main__":
    sys.exit(main())
