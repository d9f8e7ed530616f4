"""Smoke run of the batched MPC closed loop on one NVIDIA GPU.

Drives the main path once through the package API (``make_mpc``,
``run_closed_loop_lanes``, ``step_lanes``) at the bench operating point —
single cart-pole, batch 4096, ``window_length=40``, ``state_spacing=5``,
8 Gauss-Newton iterations, 5 line-search trials, f32, lanes layout — and
checks what comes out against the repo's plain references:

1. device check: JAX must find a GPU (no CPU fallback); prints the card's
   ``name, power.limit`` as ``nvidia-smi`` reports them, the JAX version,
   ``XLA_FLAGS`` and the compile-cache directory;
2. compile the single-model closed-loop program (compile time is set-up;
   ``compiled.memory_analysis()`` is printed);
3. run it for 300 ticks as chained programs: no failed solves
   (termination codes 3/4) and ``fraction_upright >= UPRIGHT_BAR``;
4. compare one MPC step on the same states (one step, not a long loop: the
   loop is chaotic): (a) f64 on the GPU vs f64 on the CPU (cold start from
   the bench's initial states), (b) f32 on the GPU vs the f64
   ``vmap(MPC.step)`` path with ``kkt_method="lu"`` on the CPU (upright,
   warm-started states after the run), (c) f32 vs the same f32 step under
   ``default_matmul_precision("highest")`` (must be identical: no f32
   product outside the solver's precision scopes may run in TF32);
5. compile the double and triple pole at the same batch and run a few
   ticks: no failed solves.

``--four`` runs only the scenario-sharded path (``make_sharded_closed_loop``,
``layout="lanes"``) over four GPUs at 4 x 4096 scenarios and the same batch
on one GPU, in f64, and compares the two.

Everything runs in this one process (a JAX process reserves most of a
card's memory). The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed;
any failure exits non-zero without it.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 4096
#: Ticks per compiled closed-loop program; the 300-tick run chains six.
TICKS_PER_PROGRAM = 50
UPRIGHT_TICKS = 300
#: The f32 swing-up at this operating point brought every instance upright
#: within 300 ticks on the accelerator the system was first built for
#: (swing-up takes about 200 ticks). The loop is chaotic,
#: so a different rounding order may flip a few marginal instances; a
#: numerical fault (reduced-precision products, a wrong kernel) loses far
#: more than 1%.
UPRIGHT_BAR = 0.99
#: (a) f64 GPU vs f64 CPU: the same arithmetic in another summation order;
#: differences stay near f64 round-off, scaled by |u|. A cold start keeps
#: every line-search decision far from a tie (large merit decreases), so
#: round-off cannot flip one.
TOL_F64_DEVICES = 1e-8
#: (b) f32 GPU vs f64 lu reference on upright warm-started states: f32
#: round-off of the elementwise rollout and condensation chain. Two runs
#: on H100s read 4.6e-5 and 5.1e-5 (the 300-tick loop reaches slightly
#: other states when the GEMMs sum in another order); 10x margin. This
#: check does not see the matmul precision: with the solver's scopes set
#: to tensorfloat32, bfloat16 or default the reading moved by under 1%.
#: The guard against TF32 is (c).
TOL_F32_VS_F64 = 5e-4
#: (b) runs the CPU f64 reference on this many instances.
N_REFERENCE = 256
#: --four: sharded vs one-card over a short cold-start loop, in f64. Both
#: run the same per-instance arithmetic, but the two programs have other
#: batch widths per card, so their GEMMs may sum in another order. In f32
#: that round-off flips line-search decisions of the swing-up from hang
#: (on H100s: 3.4% of termination codes flipped and controls differed by
#: 1.5 after 10 ticks), which says nothing about the sharding. In f64 no
#: termination code flips and the health counts must be equal; what
#: round-off can still move is the iteration at which a solve meets its
#: relative exit test (``relative_exit_tol`` 1e-5), so controls and
#: states may differ by about that much: 10x margin.
FOUR_TICKS = 10
TOL_FOUR_CONTROLS = 1e-4
TOL_FOUR_STATES = 1e-4


def scaled_error(got, want) -> float:
    """Per-instance error of ``got`` against ``want`` (leading axis =
    instances): ``max_i ||got_i - want_i||_inf / max(1, ||want_i||_inf)``.
    Non-finite values anywhere give ``inf``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape mismatch {got.shape} vs {want.shape}")
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(want))):
        return float("inf")
    g = got.reshape(got.shape[0], -1)
    w = want.reshape(want.shape[0], -1)
    num = np.max(np.abs(g - w), axis=1)
    den = np.maximum(1.0, np.max(np.abs(w), axis=1))
    return float(np.max(num / den))


def check_close(name: str, got, want, tol: float) -> dict:
    """Compare with :func:`scaled_error`; print and return the record."""
    err = scaled_error(got, want)
    rec = {"check": name, "error": err, "tol": tol, "ok": err <= tol}
    print(f"  {name}: scaled max error {err!r} (tol {tol!r}) "
          f"{'ok' if rec['ok'] else 'FAIL'}", flush=True)
    return rec


def _card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _n_failed(term) -> int:
    term = np.asarray(term)
    return int(np.sum((term == 3) | (term == 4)))


def _single_mpc(**overrides):
    from cartpole_tpu import OptimizationParams, make_mpc

    return make_mpc(OptimizationParams(
        max_iterations=8, max_line_search_iterations=5, state_spacing=5,
        window_length=40, kkt_method="condensed", **overrides,
    ))


def _params(model: str, dtype):
    import jax
    import jax.numpy as jnp

    from cartpole_tpu import get_model

    return jax.tree.map(lambda v: jnp.asarray(v, dtype),
                        get_model(model).default_params())


def _closed_loop(mpc, dp, ticks):
    """Jitted lanes closed loop with the dynamics params as closure
    constants (as ``bench.py`` runs it)."""
    import jax

    from cartpole_tpu.mpc.lanes import run_closed_loop_lanes

    return jax.jit(lambda x, s, st: run_closed_loop_lanes(
        mpc, x, dp, ticks, s, mpc_state=st))


def _cold_state(mpc, n, dtype):
    import jax.numpy as jnp

    from cartpole_tpu import MPCState

    return MPCState(previous_solution=jnp.zeros((n, mpc.spec.dim), dtype),
                    warm=jnp.zeros((n,), bool))


def phase_single(card: str, records: list):
    """Phases 2-3: compile and run the single-model closed loop; returns
    the cold-start and final ``(x, MPCState)`` and the final upright mask
    for the comparisons."""
    import jax
    import jax.numpy as jnp

    from bench import _upright_mask, make_x0s

    print("[2] single model: compile the closed loop at bench width",
          flush=True)
    mpc = _single_mpc()
    dp = _params("single", jnp.float32)
    x0s = make_x0s("single", BATCH, jnp.float32)
    sps = jnp.zeros((BATCH,), jnp.float32)
    st0 = _cold_state(mpc, BATCH, jnp.float32)
    t0 = time.perf_counter()
    compiled = _closed_loop(mpc, dp, TICKS_PER_PROGRAM).lower(
        x0s, sps, st0).compile()
    compile_s = time.perf_counter() - t0
    print(f"  compile_s {compile_s!r} (set-up)")
    print(f"  memory_analysis: {compiled.memory_analysis()}", flush=True)

    print(f"[3] single model: {UPRIGHT_TICKS} ticks as chained "
          f"{TICKS_PER_PROGRAM}-tick programs", flush=True)
    x, st = x0s, st0
    times, failed = [], 0
    for _ in range(UPRIGHT_TICKS // TICKS_PER_PROGRAM):
        t0 = time.perf_counter()
        res = jax.block_until_ready(compiled(x, sps, st))
        times.append(time.perf_counter() - t0)
        failed += _n_failed(res.termination_states)
        x, st = res.final_state, res.final_mpc_state
    upright_mask = _upright_mask(x, mpc.model.angle_indices)
    upright = float(upright_mask.mean())
    ms_tick = float(np.median(times)) / TICKS_PER_PROGRAM * 1e3
    print(f"  n_failed {failed} (must be 0)")
    print(f"  fraction_upright {upright!r} (bar {UPRIGHT_BAR})")
    print(f"  ms/tick {ms_tick!r} (median of {len(times)} programs; "
          f"program times s {times!r}; card {card})", flush=True)
    records.append({"check": "single n_failed", "ok": failed == 0})
    records.append({"check": "single fraction_upright",
                    "ok": upright >= UPRIGHT_BAR})
    return mpc, (x0s, st0), (x, st), upright_mask


def _step_fn(mpc):
    import jax

    from cartpole_tpu.mpc.lanes import step_lanes

    return jax.jit(lambda st, x, dp: step_lanes(mpc, st, x, dp, 0.0))


def _cast_state(st, dtype):
    import jax.numpy as jnp

    from cartpole_tpu import MPCState

    return MPCState(
        previous_solution=jnp.asarray(np.asarray(st.previous_solution),
                                      dtype),
        warm=jnp.asarray(np.asarray(st.warm)),
    )


def phase_compare(mpc, cold, steady, upright_mask, records: list):
    """Phase 4: one MPC step on the same states, three comparisons."""
    import jax
    import jax.numpy as jnp

    print("[4] one MPC step on the same states", flush=True)
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    step = _step_fn(mpc)

    # (a) f64 lanes step, GPU vs CPU, cold start from the bench states.
    with jax.enable_x64(True):
        x64 = jnp.asarray(np.asarray(cold[0]), jnp.float64)
        st64 = _cast_state(cold[1], jnp.float64)
        dp64 = _params("single", jnp.float64)
        on_gpu = jax.device_put((st64, x64, dp64), gpu)
        on_cpu = jax.device_put((st64, x64, dp64), cpu)
        out_g, _ = jax.block_until_ready(step(*on_gpu))
        out_c, _ = jax.block_until_ready(step(*on_cpu))
        records.append(check_close(
            f"(a) f64 u, GPU vs CPU (cold start, batch {x64.shape[0]})",
            out_g.u, out_c.u, TOL_F64_DEVICES))
        same_term = bool(np.array_equal(
            np.asarray(out_g.solver.termination_state),
            np.asarray(out_c.solver.termination_state)))
        print(f"  (a) termination codes equal: {same_term}")

        # (b) f32 lanes step on the GPU vs the f64 vmap(MPC.step) lu
        # parity path on the CPU, on upright warm-started states.
        idx = np.flatnonzero(upright_mask)[:N_REFERENCE]
        n = len(idx)
        if n == 0:
            raise RuntimeError("(b) needs upright instances; none are")
        xs = np.asarray(steady[0])[idx]
        st_n = jax.tree.map(lambda a: np.asarray(a)[idx], steady[1])
        mpc_lu = _single_lu(mpc)
        ref = jax.jit(jax.vmap(mpc_lu.step, in_axes=(0, 0, None, None)))
        ref_in = jax.device_put(
            (_cast_state(st_n, jnp.float64),
             jnp.asarray(xs, jnp.float64), dp64), cpu)
        out_ref, _ = jax.block_until_ready(ref(*ref_in, 0.0))

    dp32 = _params("single", jnp.float32)
    st32 = _cast_state(st_n, jnp.float32)
    x32 = jnp.asarray(xs, jnp.float32)
    out_32, _ = jax.block_until_ready(step(st32, x32, dp32))
    records.append(check_close(
        f"(b) f32 u on the GPU vs f64 lu reference ({n} upright "
        "warm-started instances)", out_32.u, out_ref.u, TOL_F32_VS_F64))
    print(f"  (b) f32 failed solves {_n_failed(out_32.solver.termination_state)}"
          f", f64 reference failed solves "
          f"{_n_failed(out_ref.solver.termination_state)}")

    # (c) the same f32 step with every product outside the solver's own
    # float32 scopes forced to full precision: must not change a bit.
    st_m, x_m = cold[1], cold[0]
    out_d, _ = jax.block_until_ready(step(st_m, x_m, dp32))
    with jax.default_matmul_precision("highest"):
        step_hi = _step_fn(mpc)
        out_h, _ = jax.block_until_ready(step_hi(st_m, x_m, dp32))
    ident = all(
        np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
        for a, b in zip(jax.tree.leaves(out_d), jax.tree.leaves(out_h)))
    err = scaled_error(out_d.u, out_h.u)
    print(f"  (c) f32 step identical under default_matmul_precision"
          f"('highest'): {ident} (scaled u difference {err!r}) "
          f"{'ok' if ident else 'FAIL'}", flush=True)
    records.append({"check": "(c) f32 step precision-invariant",
                    "ok": ident})


def _single_lu(mpc):
    from cartpole_tpu import make_mpc

    return make_mpc(dataclasses.replace(mpc.params, kkt_method="lu"),
                    mpc.model)


def phase_multilink(card: str, records: list):
    """Phase 5: double and triple pole at bench width, a few ticks."""
    import jax
    import jax.numpy as jnp

    from bench import DOUBLE_SOFT_OPT_KWARGS, make_x0s
    from cartpole_tpu import OptimizationParams, get_model, make_mpc

    ticks = 10
    for model in ("double", "triple"):
        print(f"[5] {model} pole: compile at batch {BATCH}, run "
              f"{2 * ticks} ticks", flush=True)
        mpc = make_mpc(OptimizationParams(
            max_iterations=8, state_spacing=5, kkt_method="condensed",
            **DOUBLE_SOFT_OPT_KWARGS), get_model(model))
        dp = _params(model, jnp.float32)
        x0s = make_x0s(model, BATCH, jnp.float32)
        sps = jnp.zeros((BATCH,), jnp.float32)
        st = _cold_state(mpc, BATCH, jnp.float32)
        t0 = time.perf_counter()
        compiled = _closed_loop(mpc, dp, ticks).lower(x0s, sps, st).compile()
        compile_s = time.perf_counter() - t0
        res = jax.block_until_ready(compiled(x0s, sps, st))
        failed = _n_failed(res.termination_states)
        t0 = time.perf_counter()
        res = jax.block_until_ready(
            compiled(res.final_state, sps, res.final_mpc_state))
        dt = time.perf_counter() - t0
        failed += _n_failed(res.termination_states)
        print(f"  compile_s {compile_s!r} (set-up); n_failed {failed} "
              f"(must be 0); ms/tick {dt / ticks * 1e3!r} (card {card})",
              flush=True)
        records.append({"check": f"{model} n_failed", "ok": failed == 0})


def phase_four(card: str, records: list):
    """--four: scenario-sharded closed loop over 4 GPUs vs one GPU."""
    import jax
    import jax.numpy as jnp

    from bench import make_x0s
    from cartpole_tpu.mpc.lanes import run_closed_loop_lanes
    from cartpole_tpu.parallel import (
        make_scenario_mesh,
        make_sharded_closed_loop,
        shard_scenarios,
    )

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    devs = devs[:4]
    n = 4 * BATCH
    print(f"[four] sharded lanes closed loop over 4 GPUs, {n} scenarios, "
          f"{FOUR_TICKS} ticks, f64, vs the same batch on one GPU",
          flush=True)
    mpc = _single_mpc()
    dp = _params("single", jnp.float64)
    x0s = make_x0s("single", n, jnp.float64)
    sps = jnp.zeros((n,), jnp.float64)

    mesh = make_scenario_mesh(devs)
    sharded = make_sharded_closed_loop(mpc, mesh, num_steps=FOUR_TICKS,
                                       layout="lanes")
    args_sh = (shard_scenarios(x0s, mesh), dp, shard_scenarios(sps, mesh))
    one = jax.jit(lambda x, d, s: run_closed_loop_lanes(
        mpc, x, d, FOUR_TICKS, s))
    args_one = jax.device_put((x0s, dp, sps), devs[0])

    def compile_x64(f, a):
        with jax.enable_x64(True):  # thread-local: the caller's does not reach
            return f.lower(*a).compile()

    # The two programs compile concurrently (XLA compiles off the GIL).
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(compile_x64, f, a)
                for f, a in ((sharded, args_sh), (one, args_one))]
        sharded_c, one_c = (f.result() for f in futs)
    print(f"  compile_s (both programs, concurrently) "
          f"{time.perf_counter() - t0!r} (set-up)")

    def timed(fn, args):
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        return out, time.perf_counter() - t0

    (res_sh, diag), t_sh = timed(sharded_c, args_sh)
    res_one, t_one = timed(one_c, args_one)
    print(f"  ms/tick: sharded {t_sh / FOUR_TICKS * 1e3!r}, one card "
          f"{t_one / FOUR_TICKS * 1e3!r} (card {card})", flush=True)

    records.append(check_close("controls, sharded vs one card",
                               res_sh.controls, res_one.controls,
                               TOL_FOUR_CONTROLS))
    records.append(check_close("final states, sharded vs one card",
                               res_sh.final_state, res_one.final_state,
                               TOL_FOUR_STATES))
    term_one = np.asarray(res_one.termination_states)
    hist_one = np.bincount(term_one.reshape(-1), minlength=5)
    hist_sh = np.asarray(diag.termination_counts)
    flips = int(np.sum(np.asarray(res_sh.termination_states) != term_one))
    print(f"  n_instances {int(diag.n_instances)} vs {n}; n_failed "
          f"{int(diag.n_failed)} vs {_n_failed(term_one)}")
    print(f"  termination histogram sharded {hist_sh.tolist()} vs one card "
          f"{hist_one.tolist()}; flipped codes {flips}", flush=True)
    records.append({"check": "four health",
                    "ok": (int(diag.n_instances) == n
                           and int(diag.n_failed) == _n_failed(term_one) == 0
                           and hist_sh.tolist() == hist_one.tolist()
                           and flips == 0)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the scenario-sharded path over four "
                    "GPUs and its one-GPU comparison")
    args = ap.parse_args(argv)

    import jax

    from cartpole_tpu.utils.device import enable_compile_cache

    print("[1] device check", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r}); "
              "this smoke run has no CPU fallback", file=sys.stderr)
        return 1
    cache_dir = enable_compile_cache()
    print("card (nvidia-smi name, power.limit):")
    lines = _card_lines()
    for line in lines:
        print(line)
    card = lines[0]
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
          f"; compile cache {cache_dir}", flush=True)

    records: list = []
    if args.four:
        with jax.enable_x64(True):
            phase_four(card, records)
    else:
        mpc, cold, steady, upright_mask = phase_single(card, records)
        phase_compare(mpc, cold, steady, upright_mask, records)
        phase_multilink(card, records)
    peak = dev.memory_stats().get("peak_bytes_in_use")
    print(f"peak_bytes_in_use (device 0): {peak}")
    bad = [r["check"] for r in records if not r["ok"]]
    if bad:
        print(f"chip_smoke: FAILED {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
