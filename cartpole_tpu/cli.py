"""Command-line interface: solve / closed-loop / sweep drivers.

The reference's offline entry point is ``model/scratch.py`` (build params,
run one solve, print ``solver_summary()``, plot). This CLI covers that
surface plus the batched/sharded sweeps this build adds. All configs
round-trip JSON with the reference's field names (``wasm.cc:23-28``).

Usage::

    python -m cartpole_tpu solve --params '{"state_spacing": 5}'
    python -m cartpole_tpu closed-loop --steps 250 --log-json log.json
    python -m cartpole_tpu sweep --batch 1024 --steps 100
    python -m cartpole_tpu replay log.json --charts charts.png --gif out.gif
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional, Sequence

__all__ = ["main"]


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model", choices=("single", "double", "triple"),
                    default="single")
    ap.add_argument("--params", default="{}",
                    help="OptimizationParams overrides as JSON")
    ap.add_argument("--dynamics", default="{}",
                    help="dynamics parameter overrides as JSON")
    ap.add_argument("--x0", default=None,
                    help="initial state as JSON list (default: hanging down)")
    ap.add_argument("--set-point", type=float, default=0.0)
    ap.add_argument("--f32", action="store_true",
                    help="f32 fast path (default: f64 parity precision)")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")


def _setup(args):
    import jax

    from .utils.device import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    if not args.f32:
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from . import OptimizationParams, get_model, make_mpc

    dtype = jnp.float32 if args.f32 else jnp.float64
    model = get_model(args.model)
    if args.model in ("double", "triple") \
            and "window_length" not in json.loads(args.params):
        # The 0.4 s default window leaves the double/triple pole on the
        # edge of its region of attraction (tests/test_double_mpc.py,
        # tests/test_triple.py) — applied to EVERY subcommand so
        # closed-loop/sweep match interactive/web.
        args.params = json.dumps(
            {**json.loads(args.params), "window_length": 60}
        )
    params = OptimizationParams.from_json(args.params)
    # from_json validates field names (a typo'd --dynamics key gets the
    # designed error listing the known fields, not a raw TypeError).
    dyn_defaults = json.loads(model.params_type().to_json())
    dynamics_params = jax.tree.map(
        lambda v: jnp.asarray(v, dtype),
        model.params_type.from_json(
            json.dumps({**dyn_defaults, **json.loads(args.dynamics)})
        ),
    )
    if args.x0 is not None:
        x0 = jnp.asarray(json.loads(args.x0), dtype)
    else:
        down = [0.0] * model.state_dim
        for a in model.angle_indices:
            down[a] = -math.pi / 2
        x0 = jnp.asarray(down, dtype)
    mpc = make_mpc(params, model)
    return mpc, dynamics_params, x0, dtype


def _cmd_solve(args) -> int:
    import jax

    from .utils import solve_log_entry, solver_summary

    mpc, dynamics_params, x0, dtype = _setup(args)
    step = jax.jit(lambda s, x: mpc.step(s, x, dynamics_params, args.set_point))
    outputs, _ = jax.block_until_ready(step(mpc.init_state(dtype), x0))
    print(solver_summary(outputs.solver))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(solve_log_entry(outputs), f)
        print(f"wrote {args.json}")
    return 0


def _cmd_closed_loop(args) -> int:
    import jax
    import numpy as np

    from . import run_closed_loop
    from .ops.solver import NLSTerminationState, termination_state_name

    mpc, dynamics_params, x0, _ = _setup(args)
    if args.schedule:
        # Time-varying solver-parameter schedule (mpc/schedule.py):
        # '[[50, {"u_derivative_cost_weight": 0.8}], [200, null]]' runs
        # 50 shaped ticks then 200 base ticks, warm start chained.
        from . import run_scheduled_closed_loop

        schedule = [
            (int(ticks), overrides)
            for ticks, overrides in json.loads(args.schedule)
        ]
        args.steps = sum(t for t, _ in schedule)

        def run(x):
            return run_scheduled_closed_loop(
                mpc, x, dynamics_params, schedule, args.set_point
            )
    else:
        run = jax.jit(
            lambda x: run_closed_loop(
                mpc, x, dynamics_params, args.steps, args.set_point
            )
        )
    t0 = time.perf_counter()
    res = jax.block_until_ready(run(x0))
    wall = time.perf_counter() - t0
    term = np.asarray(res.termination_states)
    xf = np.asarray(res.final_state)
    summary = {
        "steps": args.steps,
        "wall_s": round(wall, 3),
        "final_state": [float(v) for v in xf],
        "termination_histogram": {
            termination_state_name(k): int((term == k).sum())
            for k in range(5)
            if int((term == k).sum())
        },
        "n_failed": int(
            ((term == NLSTerminationState.QP_INDEFINITE)
             | (term == NLSTerminationState.MAX_LAMBDA)).sum()
        ),
        "max_constraint_violation_after_warmup": float(
            np.asarray(res.constraint_violations)[min(21, args.steps - 1):].max()
        ),
    }
    print(json.dumps(summary, indent=2))

    if args.log_json:
        states = np.asarray(res.states)
        controls = np.asarray(res.controls)
        entries = [
            {
                "state": [float(v) for v in states[t]],
                "u": float(controls[t]),
                "termination_state": termination_state_name(int(term[t])),
            }
            for t in range(args.steps)
        ]
        with open(args.log_json, "w") as f:
            json.dump(entries, f)
        print(f"wrote {args.log_json}")

    if args.plot:
        from .analysis import plot_closed_loop

        plot_closed_loop(
            res, control_dt=mpc.params.control_dt, save_to=args.plot
        )
        print(f"wrote {args.plot}")
    return 0


def _cmd_interactive(args) -> int:
    import jax.numpy as jnp

    mpc, dynamics_params, x0, dtype = _setup(args)
    from .interactive import InteractiveLoop

    loop = InteractiveLoop(
        params=mpc.params, dynamics_params=dynamics_params, dtype=dtype,
        model=mpc.model,
    )
    loop.x = jnp.asarray(x0, dtype)
    loop.set_point = args.set_point
    import sys as _sys

    if not _sys.stdin.isatty():
        print(
            "no tty: running 200 scripted ticks with a pole poke at t=1s",
            file=_sys.stderr,
        )
        loop.render = False
        cmds = [None] * 100 + ["p"] + [None] * 99
        loop.run(max_ticks=200, realtime=False, commands=cmds)
        xf = loop.x
        print(f"final state: {[round(float(v), 4) for v in xf]}")
        return 0
    loop.run()
    return 0


def _cmd_web(args) -> int:
    import jax.numpy as jnp

    mpc, dynamics_params, x0, dtype = _setup(args)
    from .interactive import InteractiveLoop
    from .web import serve

    loop = InteractiveLoop(
        params=mpc.params, dynamics_params=dynamics_params, dtype=dtype,
        model=mpc.model, render=False,
    )
    loop.x = jnp.asarray(x0, dtype)
    loop.set_point = args.set_point
    serve(args.host, args.port, loop=loop)
    return 0


def _cmd_sweep(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .parallel import (
        make_scenario_mesh,
        make_sharded_closed_loop,
        shard_scenarios,
    )
    from .utils.device import device_record

    mpc, dynamics_params, x0, dtype = _setup(args)
    mesh = make_scenario_mesh()
    n = args.batch
    rng = np.random.RandomState(args.seed)
    x0s = np.tile(np.asarray(x0), (n, 1))
    x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
    for a in mpc.model.angle_indices:
        x0s[:, a] += rng.uniform(-0.3, 0.3, n)
    x0s = shard_scenarios(jnp.asarray(x0s, dtype), mesh)
    sps = shard_scenarios(jnp.full((n,), args.set_point, dtype), mesh)

    layout = args.layout
    if layout == "auto":
        layout = "lanes" if mpc.params.kkt_method == "condensed" else "vmap"

    run = make_sharded_closed_loop(
        mpc, mesh, num_steps=args.steps, layout=layout
    )
    t0 = time.perf_counter()
    result, diag = jax.block_until_ready(run(x0s, dynamics_params, sps))
    wall = time.perf_counter() - t0
    xf = np.asarray(result.final_state)
    # Upright = EVERY pole angle near pi/2 (a double pole with the second
    # link hanging is not upright).
    upright = np.all(
        np.abs(xf[:, list(mpc.model.angle_indices)] - math.pi / 2) < 1e-2,
        axis=1,
    )
    print(
        json.dumps(
            {
                "batch": n,
                "steps": args.steps,
                "layout": layout,
                **device_record(list(mesh.devices.flat)),
                "wall_s": round(wall, 3),
                "solves_per_s": round(n * args.steps / wall, 1),
                "n_failed_solves": int(diag.n_failed),
                "mean_iterations": round(float(diag.mean_iterations), 3),
                "max_violation": float(diag.max_violation),
                "fraction_upright": float(upright.mean()),
            },
            indent=2,
        )
    )
    return 0


def _cmd_replay(args) -> int:
    import numpy as np

    from .ops.solver import NLSTerminationState, termination_state_name
    from .utils import load_log, replay_log

    rep = replay_log(load_log(args.log))
    term = rep.termination_states
    summary = {
        "ticks": int(rep.states.shape[0]),
        "state_dim": int(rep.states.shape[1]),
        "final_state": [float(v) for v in rep.states[-1]],
        "has_predictions": rep.predicted_states is not None,
        "termination_histogram": {
            termination_state_name(k): int((term == k).sum())
            for k in range(5)
            if int((term == k).sum())
        },
        "n_failed": int(
            ((term == NLSTerminationState.QP_INDEFINITE)
             | (term == NLSTerminationState.MAX_LAMBDA)).sum()
        ),
        "max_abs_u": float(np.abs(rep.controls).max()),
    }
    print(json.dumps(summary, indent=2))

    n_links = (rep.states.shape[1] - 2) // 2
    lengths = tuple(args.length for _ in range(n_links))
    if args.charts:
        from .viz import strip_charts

        strip_charts(rep, control_dt=args.dt, save_to=args.charts)
        print(f"wrote {args.charts}")
    if args.gif:
        from .viz import animate_closed_loop

        animate_closed_loop(
            rep, lengths=lengths, control_dt=args.dt, save_to=args.gif,
            predicted_states=rep.predicted_states,
        )
        print(f"wrote {args.gif}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="cartpole_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    ap_solve = sub.add_parser("solve", help="one MPC solve + solver summary")
    _add_common(ap_solve)
    ap_solve.add_argument("--json", default=None, help="write solve log JSON")
    ap_solve.set_defaults(fn=_cmd_solve)

    ap_cl = sub.add_parser("closed-loop", help="receding-horizon run")
    _add_common(ap_cl)
    ap_cl.add_argument("--steps", type=int, default=250)
    ap_cl.add_argument("--log-json", default=None)
    ap_cl.add_argument("--plot", default=None, help="save trajectory plot PNG")
    ap_cl.add_argument(
        "--schedule", default=None,
        help="time-varying solver-parameter schedule as JSON "
        "[[ticks, {overrides}|null], ...] (run_scheduled_closed_loop; "
        "overrides are OptimizationParams fields; overrides --steps)")
    ap_cl.set_defaults(fn=_cmd_closed_loop)

    ap_sw = sub.add_parser("sweep", help="sharded batched scenario sweep")
    _add_common(ap_sw)
    ap_sw.add_argument("--batch", type=int, default=256)
    ap_sw.add_argument("--steps", type=int, default=100)
    ap_sw.add_argument("--seed", type=int, default=0)
    ap_sw.add_argument(
        "--layout", default="auto", choices=("auto", "vmap", "lanes"),
        help="per-shard batching layout: auto picks the batch-in-lanes "
        "path (lanes) when kkt_method is condensed and the generic vmap "
        "path otherwise; lanes needs kkt_method=condensed")
    ap_sw.set_defaults(fn=_cmd_sweep)

    ap_int = sub.add_parser(
        "interactive",
        help="live terminal closed loop: poke the plant, tweak params "
        "(the web-demo capability; keys: b/B/p/P poke, c toggle "
        "controller, 1-4 mass/length, t cost<->equality, r reset, q quit)",
    )
    _add_common(ap_int)
    ap_int.set_defaults(fn=_cmd_interactive)

    ap_web = sub.add_parser(
        "web",
        help="browser demo: canvas renderer + mouse pokes + live param "
        "sliders over a local HTTP server (the reference web app's "
        "capability, solver server-side)",
    )
    _add_common(ap_web)
    ap_web.add_argument("--host", default="127.0.0.1")
    ap_web.add_argument("--port", type=int, default=8080)
    ap_web.set_defaults(fn=_cmd_web)

    ap_rp = sub.add_parser(
        "replay",
        help="re-render a saved log.json (web 'Save log' or closed-loop "
        "--log-json) as summary/strip charts/animation — no solver run",
    )
    ap_rp.add_argument("log", help="path to the saved log JSON")
    ap_rp.add_argument("--charts", default=None, help="save strip-chart PNG")
    ap_rp.add_argument("--gif", default=None,
                       help="save animation GIF (with prediction ghosts "
                       "when the log carries them)")
    ap_rp.add_argument("--dt", type=float, default=0.01,
                       help="tick duration for time axes (control_dt)")
    ap_rp.add_argument("--length", type=float, default=0.25,
                       help="per-link length for rendering")
    ap_rp.set_defaults(fn=_cmd_replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
