"""Measure constraint-row re-basing on the double pole's hard terminal
equalities (VERDICT r2 item 3).

The 5 terminal equality rows condensed across a 0.6 s window are
near-dependent (Schur cond ~1e9), which made the hard-eq mode
multiplier-ill-posed on the f32 deployment dtype (round 2; see
docs/PARITY.md). ``OptimizationParams.rebase_equalities`` orthonormalizes
the rows per instance (constraint-space QR) before the Schur elimination —
same constraint set, same exact-arithmetic step. This probe quantifies
what that buys:

  A) conditioning: cond of the equality Schur block before/after re-basing
     (f64 ground truth, jacfwd-reconstructed rows);
  B) step accuracy: one condensed_step in f32 (off/on) vs the f64
     reference — relative du error and the multiplier inf-norm;
  C) closed-loop health: f32 double-pole hard-eq loop over --ticks ticks,
     off/on — fraction upright + failed-solve counts.

Usage: python scripts/probe_hardeq_rebase.py [--batch 256] [--ticks 250]
       [--skip-loop] [--json out.json]
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

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from cartpole_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from cartpole_tpu import (
    DOUBLE_CARTPOLE, OptimizationParams, default_double_params, make_mpc,
)
from cartpole_tpu.mpc.lanes import (
    _LanesProblem, _Z, run_closed_loop_lanes,
)
from cartpole_tpu.ops.lanes import rollout_lanes

UP = math.pi / 2

#: Hard-equality double-pole configuration: the round-2 failure case.
#: Negative weights => equality rows (reference sign convention,
#: optimization.cc:236-267): th1, th2, b_x_dot, th1_dot, th2_dot — the 5
#: near-dependent rows.
#: Derived from the bench's soft regime so the window/cold-start skeleton
#: can never desynchronize; only the weight SIGNS differ.
from bench import DOUBLE_SOFT_OPT_KWARGS  # noqa: E402

HARD_EQ = dict(
    max_iterations=8,
    state_spacing=5,
    kkt_method="condensed",
    **{
        **DOUBLE_SOFT_OPT_KWARGS,
        "th_final_cost_weight": -1.0,
        "th_dot_final_cost_weight": -1.0,
        "b_x_dot_final_cost_weight": -1.0,
    },
)


def _x0s(n, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x0s = np.tile(np.array([0.0, UP, UP, 0.0, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
    x0s[:, 1] += rng.uniform(-0.15, 0.15, n)
    x0s[:, 2] += rng.uniform(-0.1, 0.1, n)
    return jnp.asarray(x0s, dtype)


def _problem_and_guess(mpc, x0s_b, dtype):
    """(sd, B) lanes problem + its cold-start shooting guess Z0."""
    dp = jax.tree.map(lambda v: jnp.asarray(v, dtype),
                      default_double_params(jnp.float64))
    spec = mpc.spec
    B = x0s_b.shape[0]
    xc = jnp.asarray(x0s_b, dtype).T
    sp_ = jnp.zeros((B,), dtype)
    u_prev = jnp.zeros((B,), dtype)
    problem = _LanesProblem(spec, xc, sp_, u_prev, dp)
    K = spec.window_length
    u0 = jnp.zeros((K, B), dtype)
    f = lambda x_, u_: spec.model.dynamics(dp, x_, u_)
    _, xs_roll = rollout_lanes(f, xc, u0, spec.params.control_dt,
                               spec.model.angle_indices, stack_states=True)
    shoot = jnp.concatenate(
        [xc[:, None, :], xs_roll[:, spec.spacing - 1::spec.spacing, :]],
        axis=1,
    )
    return problem, _Z(xs=shoot, u=u0), dp


def part_a_conditioning(out):
    """Schur-block conditioning before/after re-basing, f64 ground truth.

    Rows are reconstructed independently of the condensation code:
    A = d x_N / d u of the rolled-out terminal state (jacfwd), rows
    selected by the terminal-eq coords. C = the static u-cost Gram."""
    mpc = make_mpc(OptimizationParams(**HARD_EQ), DOUBLE_CARTPOLE)
    spec = mpc.spec
    dp = default_double_params(jnp.float64)
    K = spec.window_length
    x0 = np.array([0.1, UP + 0.12, UP - 0.08, 0.0, 0.0, 0.0])

    def term_state(u_flat):
        f = lambda x_, u_: spec.model.dynamics(dp, x_, u_)
        xe, _ = rollout_lanes(
            f, jnp.asarray(x0)[:, None], u_flat[:, None],
            spec.params.control_dt, spec.model.angle_indices,
            stack_states=True,
        )
        return xe[:, 0]

    A_full = np.asarray(jax.jacfwd(term_state)(jnp.zeros((K,))))  # (sd, K)
    coords = [ts.coord for ts in spec.terminal_eqs]
    A = A_full[coords]  # (n_t, K)

    prob, _, _ = _problem_and_guess(mpc, jnp.asarray(x0)[None], jnp.float64)
    Q = np.asarray(prob._Hu_Q)
    eigs = np.asarray(prob._Hu_eigs)
    Cinv = Q @ np.diag(1.0 / eigs) @ Q.T
    D = np.diag(np.full(len(coords), 1.0e-12))

    schur = A @ Cinv @ A.T + D
    # Re-based: orthonormal rows (QR of A^T).
    Qm, _ = np.linalg.qr(A.T)
    At = Qm.T
    schur_rb = At @ Cinv @ At.T + D
    out["cond_A_rows"] = float(np.linalg.cond(A))
    out["cond_schur"] = float(np.linalg.cond(schur))
    out["cond_schur_rebased"] = float(np.linalg.cond(schur_rb))
    print(f"A) cond(A_eq rows)           = {out['cond_A_rows']:.3e}")
    print(f"   cond(Schur)      off      = {out['cond_schur']:.3e}")
    print(f"   cond(Schur)      rebased  = {out['cond_schur_rebased']:.3e}")


def part_b_step_accuracy(out):
    """One condensed_step from the cold-start guess: f32 (off/on) vs f64."""
    B = 64
    x0s = _x0s(B, jnp.float64, seed=3)
    results = {}
    for rb in (False, True):
        mpc = make_mpc(
            OptimizationParams(rebase_equalities=rb, **HARD_EQ),
            DOUBLE_CARTPOLE,
        )
        for dtype in (jnp.float64, jnp.float32):
            prob, Z0, _ = _problem_and_guess(
                mpc, jnp.asarray(x0s, dtype), dtype
            )
            with jax.default_matmul_precision("float32"):
                dZ, nu_inf, fo, jr, ok, r, c = jax.jit(
                    prob.condensed_step
                )(Z0, jnp.zeros((B,), dtype))
            results[(rb, str(jnp.dtype(dtype)))] = (
                np.asarray(dZ.u, np.float64),
                np.asarray(nu_inf, np.float64),
            )
    du_ref = results[(False, "float64")][0]
    du_ref_rb = results[(True, "float64")][0]
    # f64 off vs on: the exact-arithmetic-identical sanity check.
    ref_agree = np.max(np.abs(du_ref - du_ref_rb)) / np.max(np.abs(du_ref))
    out["f64_off_vs_on_rel"] = float(ref_agree)
    scale = np.max(np.abs(du_ref), axis=0)  # (B,)
    for rb in (False, True):
        du32 = results[(rb, "float32")][0]
        rel = np.max(np.abs(du32 - du_ref), axis=0) / scale
        key = "rebased" if rb else "off"
        out[f"f32_step_rel_err_{key}_max"] = float(np.max(rel))
        out[f"f32_step_rel_err_{key}_med"] = float(np.median(rel))
        out[f"nu_inf_{key}_f64_max"] = float(
            np.max(results[(rb, "float64")][1])
        )
        print(f"B) f32 du rel err {key:8s}: max {np.max(rel):.3e}  "
              f"median {np.median(rel):.3e}   "
              f"nu_inf(f64) {out[f'nu_inf_{key}_f64_max']:.3e}")
    print(f"   f64 off-vs-on du rel diff: {ref_agree:.3e} "
          f"(exact-arithmetic-identical check)")


def part_c_closed_loop(out, batch, ticks):
    """f32 closed-loop health with hard equalities, off vs on, chunked at
    50 ticks/program (run it on the GPU with --gpu)."""
    from cartpole_tpu import MPCState

    dtype = jnp.float32
    chunk = 50
    dp = jax.tree.map(lambda v: jnp.asarray(v, dtype),
                      default_double_params(jnp.float64))
    x0s = _x0s(batch, dtype, seed=0)
    sps = jnp.zeros((batch,), dtype)
    for rb in (False, True):
        mpc = make_mpc(
            OptimizationParams(rebase_equalities=rb, **HARD_EQ),
            DOUBLE_CARTPOLE,
        )
        run = jax.jit(
            lambda x, s, st: run_closed_loop_lanes(
                mpc, x, dp, chunk, s, mpc_state=st
            )
        )
        x = x0s
        st = MPCState(
            previous_solution=jnp.zeros((batch, mpc.spec.dim), dtype),
            warm=jnp.zeros((batch,), bool),
        )
        terms = []
        n_iters = []
        for _ in range(max(1, ticks // chunk)):
            res = run(x, sps, st)
            x, st = res.final_state, res.final_mpc_state
            terms.append(np.asarray(res.termination_states))
            n_iters.append(np.asarray(res.solver_iterations))
        xf = np.asarray(x)
        term = np.concatenate(terms, axis=1)
        th = xf[:, 1:3]
        upright = np.mean(np.all(
            np.abs(np.mod(th - UP + math.pi, 2 * math.pi) - math.pi) < 0.1,
            axis=1,
        ))
        n_failed = int(np.sum((term == 3) | (term == 4)))
        key = "rebased" if rb else "off"
        out[f"loop_fraction_upright_{key}"] = float(upright)
        out[f"loop_n_failed_{key}"] = n_failed
        out[f"loop_mean_iters_{key}"] = float(
            np.mean(np.concatenate(n_iters, axis=1))
        )
        print(f"C) f32 {ticks}-tick loop {key:8s}: upright "
              f"{upright:.4f}  failed {n_failed}/{batch * ticks}  "
              f"mean iters {out[f'loop_mean_iters_{key}']:.2f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=250)
    ap.add_argument("--skip-loop", action="store_true")
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (default forces CPU)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--parts", default="ABC",
                    help="which parts to run (subset of 'ABC')")
    args = ap.parse_args()

    out = {"batch": args.batch, "ticks": args.ticks}
    if "A" in args.parts:
        part_a_conditioning(out)
    if "B" in args.parts:
        part_b_step_accuracy(out)
    if "C" in args.parts and not args.skip_loop:
        part_c_closed_loop(out, args.batch, args.ticks)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"-> {args.json}")


if __name__ == "__main__":
    sys.exit(main())
