"""Find the failing (instance, tick) solves in the f32 bench run."""

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
from cartpole_tpu.mpc.lanes import run_closed_loop_lanes

dtype = jnp.float32
n, ticks = 4096, 20
dp = default_single_params(dtype)
rng = np.random.RandomState(0)
x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
x0s_j = jnp.asarray(x0s, dtype)
sps = jnp.zeros((n,), dtype)

mpc = make_mpc(OptimizationParams(
    max_iterations=8, state_spacing=5, kkt_method="condensed"))
run = jax.jit(lambda x, s: run_closed_loop_lanes(mpc, x, dp, ticks, s))
res = run(x0s_j, sps)
term = np.asarray(res.termination_states)  # (B, T)
bad = np.argwhere((term == 3) | (term == 4))
print("failures (instance, tick, code):")
for b, t in bad:
    print(f"  inst {b} tick {t} code {term[b, t]} x0 {x0s[b].tolist()}")
iters = np.asarray(res.solver_iterations)
for b, t in bad[:4]:
    print(f"  inst {b}: iters over ticks {iters[b].tolist()}")
    print(f"  inst {b}: term  over ticks {term[b].tolist()}")
    print(f"  inst {b}: state at tick {t}: "
          f"{np.asarray(res.states)[b, t].tolist()}")
