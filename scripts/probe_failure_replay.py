"""Replay the failing f32 solves iteration-by-iteration on the accelerator.

Runs the failing instances' closed loop to just before the failing tick,
then manually drives the solver iterations capturing the magnitude /
finiteness of every intermediate in the condensed step.
"""

import math
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax
import jax.numpy as jnp
import numpy as np

from cartpole_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

from cartpole_tpu import OptimizationParams, default_single_params, make_mpc
from cartpole_tpu.mpc.lanes import (
    _LanesProblem, _Z, run_closed_loop_lanes,
)

dtype = jnp.float32
dp = default_single_params(dtype)
rng = np.random.RandomState(0)
n = 4096
x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
FAIL = [447, 547, 809, 951, 1005, 1285, 2127, 2939]
FAIL_TICK = [19, 19, 18, 18, 18, 18, 16, 19]
B = len(FAIL)
x0f = jnp.asarray(x0s[FAIL], dtype)
sps = jnp.zeros((B,), dtype)

mpc = make_mpc(OptimizationParams(
    max_iterations=8, state_spacing=5, kkt_method="condensed"))

# Roll to the earliest failing tick, then study one solve per instance.
t_stop = min(FAIL_TICK)
res = jax.jit(
    lambda x, s: run_closed_loop_lanes(mpc, x, dp, t_stop, s)
)(x0f, sps)
x_t = res.final_state
st_t = res.final_mpc_state
term = np.asarray(res.termination_states)
print("terms so far:", term.tolist())

# Drive iterations manually with instrumentation.
spec = mpc.spec
xc = x_t.T
u_prev_all = st_t.previous_solution[:, spec.u_start:].astype(dtype).T
u_warm = jnp.concatenate([u_prev_all[1:], u_prev_all[-1:]])
u_prev_cont = u_prev_all[0]
problem = _LanesProblem(spec, xc, sps, u_prev_cont, dp)

from cartpole_tpu.ops.lanes import rollout_lanes
f = lambda x_, u_: mpc.model.dynamics(dp, x_, u_)
_, xs_roll = rollout_lanes(f, xc, u_warm, 0.01, mpc.model.angle_indices,
                           stack_states=True)
shoot = jnp.concatenate(
    [xc[:, None, :], xs_roll[:, spec.spacing - 1::spec.spacing, :]], axis=1)
Z = _Z(xs=shoot, u=u_warm)
lam = jnp.zeros((B,), dtype)

cstep = jax.jit(problem.condensed_step)
ls_alphas = [0.5 ** i for i in range(5)]

with jax.default_matmul_precision("float32"):
    mu = jnp.full((B,), 1.0, dtype)
    for it in range(8):
        dZ, nu_inf, fo, jr, ok, r, c = cstep(Z, lam)
        stats = {
            "ok": np.asarray(ok).tolist(),
            "|du|max": float(jnp.max(jnp.abs(dZ.u))),
            "nu_inf": np.asarray(nu_inf).round(2).tolist(),
            "lam": np.asarray(lam).tolist(),
        }
        print(f"iter {it}: {stats}")
        if not np.asarray(ok).all():
            badi = int(np.argmin(np.asarray(ok)))
            print(f"  instance {FAIL[badi]} went non-finite; dumping "
                  "intermediates")
            # recompute intermediates eagerly for that instance
            stats2 = {}
            x_start, useg = problem._fold_segments(Z)
            from cartpole_tpu.ops.lanes import (
                segment_rollout_with_jac_lanes,
            )
            fj = lambda a, b: mpc.model.dynamics_jac(problem.fold(problem.S), a, b)
            x_end, Jx, Ju = segment_rollout_with_jac_lanes(
                fj, x_start, useg, 0.01, mpc.model.angle_indices)
            stats2["|Jx|max"] = float(jnp.max(jnp.abs(Jx)))
            stats2["|Ju|max"] = float(jnp.max(jnp.abs(Ju)))
            stats2["Jx finite"] = bool(jnp.all(jnp.isfinite(Jx)))
            stats2["x_end finite"] = bool(jnp.all(jnp.isfinite(x_end)))
            stats2["|x_end|max"] = float(jnp.max(jnp.abs(x_end)))
            print(f"  {stats2}")
            break
        # simple fixed-alpha accept to keep marching like the real solver
        phi0 = 0.5 * jnp.sum(r * r, axis=0) + mu * jnp.sum(jnp.abs(c), axis=0)
        best_phi, best_alpha = None, jnp.zeros((B,), dtype)
        for a in ls_alphas:
            Za = problem.retract(Z, dZ, a)
            ra, ca = problem.evaluate(Za)
            phia = 0.5 * jnp.sum(ra * ra, axis=0) + mu * jnp.sum(
                jnp.abs(ca), axis=0)
            if best_phi is None:
                best_phi, phis = phia, [phia]
            else:
                phis.append(phia)
        phis = jnp.stack(phis)
        accepts = phis <= phi0[None]
        any_acc = jnp.any(accepts, axis=0)
        idx = jnp.argmax(accepts, axis=0)
        alpha_used = jnp.where(
            any_acc, jnp.asarray(ls_alphas, dtype)[idx], 0.0)
        Z = problem.retract(Z, dZ, alpha_used)
        lam = jnp.where(any_acc, lam * 0.5, jnp.maximum(lam * 10.0, 1e-4))
        mu = jnp.maximum(mu, 2.0 * nu_inf)
