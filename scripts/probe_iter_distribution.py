"""Probe: per-tick GN-iteration distribution in the bench regime.

Measures whether a batch-wide early exit (lax.while_loop over GN
iterations instead of the fixed-trip scan) could save wall time: it can
only skip iterations where EVERY instance in the batch is done. Measured
2026-08-18 at batch 4096 x 250 ticks: max-iterations-per-tick is 8 on
every single tick (mean 5.65-7.13) -- there is always at least one
straggler instance, so the fixed-trip scan wastes nothing a global exit
could recover. Per-instance freezing already suppresses the semantic
effect of the extra trips.

Run on the accelerator: python scripts/probe_iter_distribution.py
"""
import math, os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp, numpy as np
from cartpole_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()
from cartpole_tpu import MPCState, OptimizationParams, default_single_params, make_mpc
from cartpole_tpu.mpc.lanes import run_closed_loop_lanes

B, T = 4096, 50
dtype = jnp.float32
dp = default_single_params(dtype)
mpc = make_mpc(OptimizationParams(max_iterations=8, state_spacing=5))
rng = np.random.RandomState(0)
x0s = np.tile(np.array([0.0, -math.pi/2, 0.0, 0.0]), (B, 1))
x0s[:, 0] += rng.uniform(-0.5, 0.5, B); x0s[:, 1] += rng.uniform(-0.5, 0.5, B)
x0s = jnp.asarray(x0s, dtype)
sps = jnp.zeros((B,), dtype)
st = MPCState(previous_solution=jnp.zeros((B, mpc.spec.dim), dtype),
              warm=jnp.zeros((B,), bool))
run = jax.jit(lambda x, s, st_: run_closed_loop_lanes(mpc, x, dp, T, s, mpc_state=st_))
x = x0s
for chunk in range(5):  # 250 ticks
    res = run(x, sps, st)
    iters = np.asarray(res.solver_iterations)  # (B, T)? check layout
    x, st = res.final_state, res.final_mpc_state
    per_tick_max = iters.max(axis=0) if iters.shape[0] == B else iters.max(axis=1)
    per_tick_mean = iters.mean(axis=0) if iters.shape[0] == B else iters.mean(axis=1)
    print(f"ticks {chunk*T}-{chunk*T+T}: shape {iters.shape} "
          f"max/tick {per_tick_max.tolist()[:10]}... "
          f"overall mean {iters.mean():.2f}, frac ticks max=8: "
          f"{(per_tick_max == 8).mean():.2f}, max<=3: {(per_tick_max <= 3).mean():.2f}",
          flush=True)
