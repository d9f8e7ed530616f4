"""Reachability analysis of the double-pole bench's stuck knockdowns
(VERDICT r2 item 2b, follow-up to scripts/probe_knockdowns.py).

probe_knockdowns.py showed the stuck set (down at tick 500) does NOT
respond to swing-up-sinusoid warm-start kicks at u_limit 300 (4-5/31
recover vs 6/31 control). This probe isolates WHY, on the saved stuck
states (knockdowns.json):

  A) same soft stabilization config but u_limit 600: if they recover,
     the 300 N force limit is the binding obstruction;
  B) the full swing-up configuration (hard terminal equalities, default
     sinusoid cold start, f64) at u_limit 300: the controller's best
     swing-up machinery on the stuck states;
  C) swing-up from clean HANG at u_limit 300 vs 600 (f64): whether
     double-pole swing-up at 300 is feasible for this controller AT ALL
     (the passing test, tests/test_double_mpc.py::test_swingup_closed_loop,
     requires 600);
  E) energy analysis of the stuck states (pure NumPy, always runs): total
     mechanical energy vs the hang->upright gap, |th_dot| and |b_x|
     extrema, and the assembled verdict string.

Part A (f32, the deployment dtype) runs on the GPU with --gpu; parts B/C
are f64 reachability questions and default to CPU.

Usage: python scripts/probe_knockdown_reachability.py
       [--stuck knockdowns.json] [--json out.json] [--parts ABC]
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax

from cartpole_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_enable_x64", True)
if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from cartpole_tpu import OptimizationParams, get_model, make_mpc
from cartpole_tpu.mpc.lanes import run_closed_loop_lanes

UP = math.pi / 2
CHUNK = 50


def _upright(xf):
    th = np.asarray(xf)[:, 1:3]
    return np.all(
        np.abs(np.mod(th - UP + math.pi, 2 * math.pi) - math.pi) < 0.1,
        axis=1,
    )


def _run_chunked(mpc, x0s, dtype, ticks):
    """Chunked closed loop (``CHUNK`` ticks per compiled program)."""
    from cartpole_tpu import MPCState

    dp = jax.tree.map(lambda v: jnp.asarray(v, dtype),
                      get_model("double").default_params())
    x = jnp.asarray(x0s, dtype)
    B = x.shape[0]
    sps = jnp.zeros((B,), dtype)
    st = MPCState(
        previous_solution=jnp.zeros((B, mpc.spec.dim), dtype),
        warm=jnp.zeros((B,), bool),
    )
    run = jax.jit(
        lambda x_, st_: run_closed_loop_lanes(
            mpc, x_, dp, CHUNK, sps, mpc_state=st_
        )
    )
    failed = 0
    for _ in range(ticks // CHUNK):
        res = run(x, st)
        x, st = res.final_state, res.final_mpc_state
        term = np.asarray(res.termination_states)
        failed += int(np.sum((term == 3) | (term == 4)))
    return np.asarray(x), failed


from bench import DOUBLE_SOFT_OPT_KWARGS  # noqa: E402 - the bench regime

SOFT = dict(
    max_iterations=8, state_spacing=5, kkt_method="condensed",
    **DOUBLE_SOFT_OPT_KWARGS,
)
SWINGUP = dict(
    max_iterations=10, state_spacing=5, kkt_method="condensed",
    window_length=60,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stuck", default="knockdowns.json")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--json", default="knockdown_reachability.json")
    ap.add_argument("--parts", default="ABC",
                    help="which experiments to run (subset of 'ABC')")
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (default forces CPU; use for "
                    "part A, the f32 deployment-dtype case)")
    args = ap.parse_args()

    with open(args.stuck) as f:
        kd = json.load(f)
    stuck = np.asarray(kd["stuck_states"])
    n = len(stuck)
    # Pad to a multiple of 8 lanes with copies (dropped in the readout).
    pad = (-n) % 8
    xs = np.concatenate([stuck, stuck[:pad]], axis=0) if pad else stuck
    out = {"n_stuck": n}
    print(f"{n} stuck states loaded")

    # A) soft config, u_limit 600, f32 (the deployment dtype)
    if "A" in args.parts:
        _part_a(out, xs, n, args)

    # B) swing-up config (hard eqs + sinusoid cold start), u 300, f64
    if "B" in args.parts:
        _part_b(out, xs, n, args)

    # C) clean hang, swing-up config, u 300 vs 600, f64
    if "C" in args.parts:
        _part_c(out, args)

    # E) energy analysis + verdict (pure NumPy; always reproducible)
    _part_energy(out, stuck, kd)

    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.json}")


def _double_energy(x):
    """Total mechanical energy of the cart + two-link pole (point masses
    at the link tips, the model of ``models/params.py::DoubleCartPoleParams``;
    PE zero at the cart rail). State rows are
    ``[b_x, th_1, th_2, b_x_dot, th_1_dot, th_2_dot]``, upright = pi/2."""
    p = get_model("double").default_params()
    b_d, th1, th2 = x[:, 3], x[:, 1], x[:, 2]
    th1_d, th2_d = x[:, 4], x[:, 5]
    v1 = np.stack([b_d - p.l_1 * np.sin(th1) * th1_d,
                   p.l_1 * np.cos(th1) * th1_d])
    v2 = v1 + np.stack([-p.l_2 * np.sin(th2) * th2_d,
                        p.l_2 * np.cos(th2) * th2_d])
    ke = 0.5 * (p.m_b * b_d ** 2 + p.m_1 * np.sum(v1 ** 2, axis=0)
                + p.m_2 * np.sum(v2 ** 2, axis=0))
    pe = p.g * (p.m_1 * p.l_1 * np.sin(th1)
                + p.m_2 * (p.l_1 * np.sin(th1) + p.l_2 * np.sin(th2)))
    return ke + pe


def _part_energy(out, stuck, kd):
    """Why the stuck set is unrecoverable: excess mechanical energy."""
    e = _double_energy(stuck)
    up = _double_energy(np.array([[0.0, UP, UP, 0.0, 0.0, 0.0]]))[0]
    hang = _double_energy(np.array([[0.0, -UP, -UP, 0.0, 0.0, 0.0]]))[0]
    gap = up - hang  # the entire hang->upright swing-up quantum
    excess = (e - up) / gap
    th_dot_max = float(np.abs(stuck[:, 4:6]).max())
    b_x_max = float(np.abs(stuck[:, 0]).max())
    out.update({
        "energy_upright_rest": round(float(up), 2),
        "energy_hang_rest": round(float(hang), 2),
        "stuck_energy_median": round(float(np.median(e)), 1),
        "stuck_energy_max": round(float(e.max()), 1),
        "stuck_excess_energy_vs_swingup_gap_median_x":
            round(float(np.median(excess)), 1),
        "stuck_excess_energy_vs_swingup_gap_max_x":
            round(float(excess.max()), 1),
    })
    kicks = sorted(
        kd.get(k, 0) for k in
        ("kick_50_recovered", "kick_150_recovered", "kick_300_recovered")
    )
    out["conclusion"] = (
        "The stuck set is high-energy tumbling (|th_dot| up to "
        f"{th_dot_max:.0f} rad/s, median "
        f"{out['stuck_excess_energy_vs_swingup_gap_median_x']:g}x / max "
        f"{out['stuck_excess_energy_vs_swingup_gap_max_x']:g}x the entire "
        "hang->upright energy gap as EXCESS energy), not rail-pinned "
        f"(|b_x| <= {b_x_max:.1f} of 5.0) and not force- or "
        "config-limited: clean-hang swing-up at u_limit 300 succeeds "
        f"{out.get('hang_swingup_u300_recovered', '?')}/8, while NO "
        "intervention on the stuck states (control "
        f"{kd.get('control_recovered', '?')}/{out['n_stuck']}, sinusoid "
        f"kicks {kicks[0]}-{kicks[-1]}/{out['n_stuck']} at amplitudes "
        "50/150/300, u_limit 600 "
        f"{out.get('soft_ulimit600_recovered', '?')}/{out['n_stuck']}, "
        "full f64 swing-up config "
        f"{out.get('swingup_u300_recovered', '?')}/{out['n_stuck']}) beats "
        "the chaotic do-nothing baseline. Dissipating tens of swing-up "
        "quanta through the cart coupling on a 0.6 s receding horizon is "
        "outside the controller's authority; the product answer is "
        "detection (MPC.knockdown_mask/knockdown_report)."
    )
    print(f"E) energy: median {out['stuck_energy_median']} / max "
          f"{out['stuck_energy_max']} J (gap {gap:.2f} J); "
          f"|th_dot|max {th_dot_max:.0f} rad/s, |b_x|max {b_x_max:.1f}")


def _part_a(out, xs, n, args):
    mpc = make_mpc(OptimizationParams(u_limit=600.0, **SOFT),
                   get_model("double"))
    xf, failed = _run_chunked(mpc, xs, jnp.float32, args.ticks)
    rec = int(_upright(xf)[:n].sum())
    out["soft_ulimit600_recovered"] = rec
    out["soft_ulimit600_failed_solves"] = failed
    print(f"A) soft+u600   : {rec}/{n} recovered  (failed solves {failed})")


def _part_b(out, xs, n, args):
    mpc = make_mpc(OptimizationParams(**SWINGUP), get_model("double"))
    xf, failed = _run_chunked(mpc, xs, jnp.float64, args.ticks)
    rec = int(_upright(xf)[:n].sum())
    out["swingup_u300_recovered"] = rec
    out["swingup_u300_failed_solves"] = failed
    print(f"B) swingup u300: {rec}/{n} recovered  (failed solves {failed})")


def _part_c(out, args):
    hang = np.tile(np.array([0.0, -UP, -UP, 0.0, 0.0, 0.0]), (8, 1))
    hang[:, 0] += np.linspace(-0.1, 0.1, 8)
    for ul in (300.0, 600.0):
        mpc = make_mpc(OptimizationParams(u_limit=ul, **SWINGUP),
                       get_model("double"))
        xf, failed = _run_chunked(mpc, hang, jnp.float64, args.ticks)
        rec = int(_upright(xf).sum())
        out[f"hang_swingup_u{ul:g}_recovered"] = rec
        print(f"C) hang u{ul:g}: {rec}/8 swing up  (failed solves {failed})")


if __name__ == "__main__":
    sys.exit(main())
