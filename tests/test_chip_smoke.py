"""``chip_smoke.py``: no CPU fallback, and its comparison helper.

The smoke run itself needs an NVIDIA GPU; ``test_smoke_run_on_the_card``
runs it there (``gpu`` marker) and skips elsewhere.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_smoke(env, *args, timeout):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


def test_exits_nonzero_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = _run_smoke(env, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_check_close_passes_at_tiny_shapes():
    """Two independent paths (lanes vs vmap condensed, f64) agree under
    the helper at the f64 device tolerance."""
    from cartpole_tpu import OptimizationParams, default_single_params, make_mpc
    from cartpole_tpu.mpc.lanes import step_lanes

    mpc = make_mpc(OptimizationParams(
        window_length=10, state_spacing=5, max_iterations=4,
        kkt_method="condensed", analytic_jacobians=True))
    dp = default_single_params(jnp.float64)
    B = 3
    rng = np.random.RandomState(0)
    x = np.tile([0.0, -np.pi / 2, 0.0, 0.0], (B, 1))
    x[:, 1] += rng.uniform(-0.3, 0.3, B)
    x = jnp.asarray(x)
    st = jax.vmap(lambda _: mpc.init_state(jnp.float64))(jnp.arange(B))
    out_l, _ = jax.jit(lambda s, x_: step_lanes(mpc, s, x_, dp, 0.0))(st, x)
    out_v, _ = jax.jit(jax.vmap(mpc.step, in_axes=(0, 0, None, None)))(
        st, x, dp, 0.0)
    rec = chip_smoke.check_close("lanes vs vmap", out_l.u, out_v.u,
                                 chip_smoke.TOL_F64_DEVICES)
    assert rec["ok"] and rec["error"] <= chip_smoke.TOL_F64_DEVICES

    # ...and catches a perturbation of one control of one instance.
    bad = np.asarray(out_l.u).copy()
    bad[1, 3] += 1e-6
    rec = chip_smoke.check_close("perturbed", bad, out_v.u,
                                 chip_smoke.TOL_F64_DEVICES)
    assert not rec["ok"]
    assert rec["error"] > chip_smoke.TOL_F64_DEVICES


def test_scaled_error_is_per_instance_relative():
    want = np.array([[100.0, -50.0], [0.1, 0.2]])
    got = want + np.array([[1.0, 0.0], [0.0, 0.01]])
    # row 0: 1 / 100; row 1 (|want| < 1): 0.01 / 1.
    assert chip_smoke.scaled_error(got, want) == pytest.approx(0.01)


def test_scaled_error_rejects_non_finite_and_shape_mismatch():
    want = np.zeros((2, 3))
    got = want.copy()
    got[0, 1] = np.nan
    assert chip_smoke.scaled_error(got, want) == float("inf")
    assert not chip_smoke.check_close("nan", got, want, 1.0)["ok"]
    with pytest.raises(ValueError, match="shape mismatch"):
        chip_smoke.scaled_error(np.zeros((2, 2)), want)


@pytest.mark.gpu
def test_smoke_run_on_the_card(gpu_card):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = _run_smoke(env, timeout=1500)
    assert res.returncode == 0, (gpu_card, res.stderr[-4000:])
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


@pytest.mark.parametrize("markexpr,want", [
    ("", False),
    ("not slow", False),
    ("gpu", True),
    ("gpu and not slow", True),
    ("not gpu", False),
])
def test_gpu_tests_run_only_when_asked_for(markexpr, want):
    """The smoke run on the card is far longer than the CPU suite, so a
    plain run skips it even on a GPU machine."""
    from conftest import gpu_tests_requested

    assert gpu_tests_requested(markexpr) is want
