"""Headline benchmark: batched closed-loop MPC solves/s on one device.

Measures the BASELINE.json single-device config — 4096 swing-up scenarios,
full receding-horizon regime (every tick: MPC solve -> apply u[0] to the
1 kHz plant -> carry the warm start), all compiled into one XLA program —
and prints ONE JSON line naming the device it ran on. This is the honest
regime: each solve sees a new plant state, exactly like the reference's
browser loop (``viz/src/application.ts:424-458``).

The timed program uses the batch-in-lanes condensed path (``mpc/lanes.py``,
``--layout lanes``); ``--layout vmap`` times the generic vmapped path.
After the timing runs, the SAME compiled program (warm-start state is an
explicit argument, so chaining never retraces) is continued in chunks
carrying ``(plant state, MPCState)`` across calls to demonstrate full
swing-up at the bench operating point (>= 250 ticks) — reported as
``fraction_upright``.

Without ``--cpu`` the run needs an accelerator and fails if JAX finds
none; ``--cpu`` is an explicit CI smoke run whose times are not device
metrics.

Baseline anchor: the reference publishes no numbers (BASELINE.md); its
implied budget is one MPC solve per 10 ms control tick on a single
browser/WASM thread (``optimization.hpp:14``, ``application.ts:393-399``),
i.e. 100 solves/s. ``vs_baseline`` is solves/s relative to that.

Usage: python bench.py [--batch 4096] [--ticks 100] [--reps 3] [--f64]
       python bench.py --sweep   # latency/throughput matrix -> bench_sweep.json
"""

import argparse
import copy
import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_SOLVES_PER_S = 100.0  # 1 solve / 10 ms real-time budget, 1 thread.

#: The multi-link disturbance-rejection regime (shared with the probe
#: scripts so they always characterize the regime the bench actually
#: runs): 0.6 s window (the 0.4 s default leaves double-pole
#: perturbations on the edge of the region of attraction,
#: tests/test_double_mpc.py), ALL terminal objectives as soft costs (the
#: reference's positive-weight mode; the double pole's 5-row hard
#: terminal equality set is multiplier-ill-posed on the f32 deployment
#: dtype, docs/PARITY.md), and no swing-up sinusoid kick.
DOUBLE_SOFT_OPT_KWARGS = dict(
    window_length=60,
    th_final_cost_weight=150.0,
    th_dot_final_cost_weight=10.0,
    b_x_dot_final_cost_weight=10.0,
    u_guess_sinusoid_amplitude=0.0,
)

#: Transient shaping for the double pole's first ~50 cold-start ticks
#: (scripts/probe_transient_shaping.py, f32, batch 4096): an 8x
#: u-rate-limit during the transient prevents the high-energy tumbling
#: knockdowns at the SOURCE — 250-tick knockdowns 76 -> 18, replicated on
#: seeds 1/2 (72 -> 20, 83 -> 14), zero failed solves. Dose-response is
#: monotone (0.2/0.4/0.8x weights -> 80/45/18) and the same weight applied
#: FOREVER is worse than baseline (133: the controller needs its agility
#: back after the transient). Applied by _double_health via
#: run_scheduled_closed_loop for exactly DOUBLE_TRANSIENT_TICKS ticks: the
#: dose is part of the measurement (overdosing re-enters the "applied
#: forever is worse" regime).
DOUBLE_TRANSIENT_OPT_KWARGS = dict(u_derivative_cost_weight=0.8)
DOUBLE_TRANSIENT_TICKS = 50


def make_x0s(model, n, dtype, seed=0):
    """Bench initial states (shared with the probe scripts): swing-up from
    hang for the single model, perturbed-upright disturbance rejection for
    the multi-link models."""
    rng = np.random.RandomState(seed)
    if model == "triple":
        up = math.pi / 2
        x0s = np.tile(np.array([0.0, up, up, up, 0.0, 0.0, 0.0, 0.0]),
                      (n, 1))
        x0s[:, 0] += rng.uniform(-0.2, 0.2, n)
        x0s[:, 1:4] += rng.uniform(-0.06, 0.06, (n, 3))
    elif model == "double":
        # Perturbed-upright stabilization: double-pole swing-up from hang
        # is covered in tests/test_double_mpc.py; the bench regime is the
        # (much more common in deployment) disturbance-rejection loop.
        up = math.pi / 2
        x0s = np.tile(np.array([0.0, up, up, 0.0, 0.0, 0.0]), (n, 1))
        x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
        x0s[:, 1] += rng.uniform(-0.15, 0.15, n)
        x0s[:, 2] += rng.uniform(-0.1, 0.1, n)
    else:
        x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
        x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
        x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
    return jnp.asarray(x0s, dtype)


def _build_runner(args, ticks, kkt, dtype, dp, extra_opt_kwargs=None):
    """Returns ``(mpc, jitted run(x0s, sps, mpc_state), effective_layout)``.

    The runner takes the warm-start state EXPLICITLY so the cold start, the
    timing reps, and the chunked swing-up demonstration all share one
    compiled program — chaining chunks never retraces.
    """
    from cartpole_tpu import OptimizationParams, get_model, make_mpc
    from cartpole_tpu.mpc.lanes import run_closed_loop_lanes
    from cartpole_tpu.mpc.closed_loop import run_closed_loop

    opt_kwargs = dict(
        max_iterations=8, state_spacing=args.spacing, kkt_method=kkt
    )
    if args.model in ("double", "triple"):
        opt_kwargs.update(DOUBLE_SOFT_OPT_KWARGS)
    if extra_opt_kwargs:
        opt_kwargs.update(extra_opt_kwargs)
    mpc = make_mpc(OptimizationParams(**opt_kwargs), get_model(args.model))
    # ``dp`` is captured as a closure CONSTANT, not a traced argument:
    # XLA then constant-folds the parameter arithmetic inside the
    # generated dynamics kernels. Same deployment semantics as the
    # reference, whose UI rebuilds the optimizer whenever dynamics params
    # change (viz/src/application.ts:279-373); our interactive driver does
    # too.
    layout = "lanes" if (args.layout == "lanes" and kkt == "condensed") \
        else "vmap"
    if layout == "lanes":
        def run(x0s, sps, st):
            return run_closed_loop_lanes(
                mpc, x0s, dp, ticks, sps, mpc_state=st
            )
    else:
        if args.layout == "lanes":
            print(f"note: --layout lanes requires --kkt condensed; "
                  f"timing the vmapped path for kkt={kkt}", file=sys.stderr)

        def run(x0s, sps, st):
            return jax.vmap(
                lambda x, s, st_: run_closed_loop(
                    mpc, x, dp, ticks, s, mpc_state=st_
                )
            )(x0s, sps, st)
    return mpc, jax.jit(run), layout


def _cold_state(mpc, n, dtype):
    from cartpole_tpu import MPCState

    return MPCState(
        previous_solution=jnp.zeros((n, mpc.spec.dim), dtype),
        warm=jnp.zeros((n,), bool),
    )


def _compile(run, example_args):
    """AOT-compile ``run`` -> ``(compiled, compile_s)``; the compiled
    program serves the timing and the chained continuation, so nothing
    compiles twice."""
    t0 = time.perf_counter()
    compiled = run.lower(*example_args).compile()
    return compiled, time.perf_counter() - t0


def _time_run(run, x0s, sps, st0, reps):
    """Best-of-``reps`` wall time of one call (after one warm-up call),
    synchronized with ``block_until_ready``."""
    res = jax.block_until_ready(run(x0s, sps, st0))
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(x0s, sps, st0))
        best = min(best, time.perf_counter() - t0)
    return best, res


def _health(res):
    term = np.asarray(res.termination_states)
    return int(np.sum((term == 3) | (term == 4)))


def _upright_mask(xf, angle_indices=(1,)):
    """Per instance: every pole angle within 0.1 rad of upright."""
    th = np.asarray(xf)[:, list(angle_indices)]
    return np.all(
        np.abs(np.mod(th - math.pi / 2 + math.pi, 2 * math.pi) - math.pi)
        < 0.1,
        axis=1,
    )


def _upright_fraction(xf, angle_indices=(1,)):
    return float(np.mean(_upright_mask(xf, angle_indices)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=100,
                    help="receding-horizon steps per compiled program")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--f64", action="store_true",
                    help="parity precision instead of the f32 fast path")
    ap.add_argument("--spacing", type=int, default=5,
                    help="state_spacing (reference test uses 5)")
    ap.add_argument("--kkt", default="condensed",
                    choices=("condensed", "schur", "lu"))
    ap.add_argument("--model", default="single",
                    choices=("single", "double", "triple"),
                    help="model family (double = 6-state double pole, a "
                    "capability the reference left WIP; triple = 8-state "
                    "three-link chain, beyond the reference's roadmap)")
    ap.add_argument("--layout", default="lanes", choices=("lanes", "vmap"),
                    help="batching layout (lanes = batch-in-lanes fast "
                    "path; requires condensed)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (CI smoke run; its times "
                    "are not device metrics)")
    ap.add_argument("--no-upright", action="store_true",
                    help="skip the chunked swing-up demonstration")
    ap.add_argument("--no-double", action="store_true",
                    help="skip the double-pole health measurement that "
                    "rides along with the default single-model run")
    ap.add_argument("--upright-ticks", type=int, default=250,
                    help="minimum total closed-loop ticks for the "
                    "demonstration (rounded up to a whole chunk)")
    ap.add_argument("--sweep", action="store_true",
                    help="latency/throughput matrix over batch sizes -> "
                    "bench_sweep.json (single JSON line still printed)")
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    from cartpole_tpu import get_model
    from cartpole_tpu.utils.device import device_record, enable_compile_cache

    enable_compile_cache()
    dev = device_record(jax.devices()[:1])
    if dev["platform"] == "cpu" and not args.cpu:
        print("bench.py: JAX found no accelerator; pass --cpu for a CPU "
              "smoke run (its times are not device metrics)",
              file=sys.stderr)
        return 2
    dp = jax.tree.map(
        lambda v: jnp.asarray(v, dtype),
        get_model(args.model).default_params(),
    )

    if args.sweep:
        return _sweep(args, dp, dtype, dev)

    n, ticks = args.batch, args.ticks
    mpc, run, layout = _build_runner(args, ticks, args.kkt, dtype, dp)
    x0s = make_x0s(args.model, n, dtype)
    sps = jnp.zeros((n,), dtype)
    st0 = _cold_state(mpc, n, dtype)

    compiled, compile_s = _compile(run, (x0s, sps, st0))
    best, res = _time_run(compiled, x0s, sps, st0, args.reps)
    n_failed = _health(res)

    solves = n * ticks
    solves_per_s = solves / best
    tick_latency_ms = best / ticks * 1e3  # full-batch closed-loop tick

    # Outcome proof at the perf operating point: continue the SAME compiled
    # program from the timed run in chunks carrying (x, MPCState) until at
    # least --upright-ticks total ticks have been simulated.
    upright = None
    upright_failed = None
    upright_ticks_run = None
    if not args.no_upright and not args.f64:
        x, st = res.final_state, res.final_mpc_state
        ticks_run = ticks
        total_failed = _health(res)
        while ticks_run < args.upright_ticks:
            res_c = compiled(x, sps, st)
            x = res_c.final_state
            st = res_c.final_mpc_state
            ticks_run += ticks
            total_failed += _health(res_c)
        upright = _upright_fraction(x, mpc.model.angle_indices)
        upright_failed = total_failed
        upright_ticks_run = ticks_run

    # Double-pole health rides along with the default single-model run so
    # the one-line artifact captures BOTH regimes: throughput + upright
    # fraction of the perturbed-upright disturbance-rejection loop at the
    # same batch/tick operating point.
    double = {}
    if args.model == "single" and not args.no_double and not args.f64:
        double = _double_health(args, dtype, dp_model="double")

    print(json.dumps({
        "metric": "batched_mpc_solves_per_s_per_chip",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 2),
        "batch": n,
        "ticks": ticks,
        # All solves in the batch complete together, so the full-batch tick
        # latency IS the (p50 = p99) per-solve latency.
        "p99_solve_latency_ms": round(tick_latency_ms, 3),
        "compile_s": compile_s,
        "kkt_method": args.kkt,
        "layout": layout,
        "model": args.model,
        "dtype": str(np.dtype(dtype).name),
        **dev,
        "n_failed": n_failed,
        **({"fraction_upright": round(upright, 4),
            "upright_ticks": upright_ticks_run,
            "upright_n_failed": upright_failed}
           if upright is not None else {}),
        **double,
    }))
    return 0


def _double_health(args, dtype, dp_model="double"):
    """Measure the double-pole disturbance-rejection regime and return
    ``double_*`` fields for the one-line artifact.

    Same operating point as the headline run (batch/ticks/reps), the
    all-soft terminal configuration ``_build_runner`` selects for the
    double model, and the chunked continuation for the upright fraction.
    """
    from cartpole_tpu import get_model

    dargs = copy.copy(args)
    dargs.model = dp_model
    dp = jax.tree.map(
        lambda v: jnp.asarray(v, dtype),
        get_model(dargs.model).default_params(),
    )
    n, ticks = dargs.batch, dargs.ticks
    # Timed chunk: the steady-state configuration (same program the
    # scheduled outcome's base phase runs, so its compile is shared via
    # the persistent cache).
    mpc, run, _layout = _build_runner(dargs, ticks, dargs.kkt, dtype, dp)
    x0s = make_x0s(dargs.model, n, dtype)
    sps = jnp.zeros((n,), dtype)
    st0 = _cold_state(mpc, n, dtype)
    best, res = _time_run(run, x0s, sps, st0, dargs.reps)
    total_failed = _health(res)
    out = {"double_solves_per_s": round(n * ticks / best, 1)}
    if dargs.no_upright:
        # Timing-only run: honor --no-upright for the ride-along too.
        return {**out, "double_n_failed": total_failed}

    # Outcome through the PUBLIC time-varying-schedule API
    # (run_scheduled_closed_loop, mpc/schedule.py): transient override for
    # the first DOUBLE_TRANSIENT_TICKS, base controller for the rest —
    # what a deployment would call, not bench-side hand-chunking. The
    # schedule's lanes layout needs the condensed KKT (step_lanes); for
    # --kkt lu/schur comparison runs the outcome chains the timed vmap
    # runner instead (no transient shaping — those paths are for solver
    # comparison, not the headline regime).
    if dargs.kkt != "condensed":
        x, st = res.final_state, res.final_mpc_state
        ticks_run = ticks
        while ticks_run < dargs.upright_ticks:
            res_c = run(x, sps, st)
            x = res_c.final_state
            st = res_c.final_mpc_state
            ticks_run += ticks
            total_failed += _health(res_c)
        return {
            **out,
            "double_fraction_upright": round(
                _upright_fraction(x, mpc.model.angle_indices), 4),
            "double_upright_ticks": ticks_run,
            "double_n_failed": total_failed,
            "double_transient": "none (non-condensed comparison path)",
        }

    from cartpole_tpu import run_scheduled_closed_loop

    t_tr = min(DOUBLE_TRANSIENT_TICKS, dargs.upright_ticks)
    res_s = run_scheduled_closed_loop(
        mpc, x0s, dp,
        [(t_tr, DOUBLE_TRANSIENT_OPT_KWARGS),
         (max(dargs.upright_ticks - t_tr, 1), None)],
        sps, layout="lanes", max_ticks_per_program=ticks,
    )
    x = res_s.final_state
    term = np.asarray(res_s.termination_states)
    return {
        **out,
        "double_fraction_upright": round(
            _upright_fraction(x, mpc.model.angle_indices), 4),
        "double_upright_ticks": int(term.shape[1]),
        "double_n_failed": int(np.sum((term == 3) | (term == 4))),
        "double_transient": (
            f"run_scheduled_closed_loop: u_derivative_cost_weight="
            f"{DOUBLE_TRANSIENT_OPT_KWARGS['u_derivative_cost_weight']} "
            f"for the first {t_tr} ticks (knockdown prevention, "
            "scripts/probe_transient_shaping.py)"
        ),
    }


def _sweep(args, dp, dtype, dev):
    """Latency/throughput matrix: batch sweep at the default path,
    written machine-readable."""
    rows = []
    batches = (64, 256, 1024, 4096, 8192, 16384)
    for n in batches:
        nargs = copy.copy(args)
        nargs.batch = n
        mpc, run, layout = _build_runner(nargs, args.ticks, args.kkt,
                                         dtype, dp)
        x0s = make_x0s(args.model, n, dtype)
        sps = jnp.zeros((n,), dtype)
        st0 = _cold_state(mpc, n, dtype)
        best, res = _time_run(run, x0s, sps, st0, args.reps)
        rows.append({
            "batch": n,
            "ticks": args.ticks,
            "kkt_method": args.kkt,
            "layout": layout,
            "solves_per_s": round(n * args.ticks / best, 1),
            "tick_latency_ms": round(best / args.ticks * 1e3, 3),
            "meets_10ms_budget": bool(best / args.ticks < 0.010),
            "n_failed": _health(res),
            **dev,
            "dtype": str(np.dtype(dtype).name),
        })
        print(json.dumps(rows[-1]), file=sys.stderr)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bench_sweep.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    best_row = max(rows, key=lambda r: r["solves_per_s"])
    rt = [r for r in rows if r["meets_10ms_budget"]]
    print(json.dumps({
        "metric": "batched_mpc_solves_per_s_per_chip",
        "value": best_row["solves_per_s"],
        "unit": "solves/s",
        "vs_baseline": round(best_row["solves_per_s"] / BASELINE_SOLVES_PER_S,
                             2),
        "sweep": out,
        "largest_batch_meeting_10ms": (max(r["batch"] for r in rt)
                                       if rt else 0),
        **dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
