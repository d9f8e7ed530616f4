"""Real multi-process distributed execution (jax.distributed + Gloo).

Two OS processes, four virtual CPU devices each, one GLOBAL 8-device
scenario mesh: the closed-loop sweep runs sharded across both processes
and the psum'd diagnostics agree — the mechanism a multi-host run uses
(SURVEY.md §5 distributed backend), validated without several hosts.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

_WORKER = r'''
import os, sys, json
proc_id = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc, process_id=proc_id,
)
import math
import numpy as np, jax.numpy as jnp
sys.path.insert(0, sys.argv[4])
from cartpole_tpu import OptimizationParams, default_single_params, make_mpc
from cartpole_tpu.parallel import (
    make_scenario_mesh, make_sharded_closed_loop, scenario_sharding,
)

mpc = make_mpc(OptimizationParams(max_iterations=4, state_spacing=5))
dp = default_single_params(jnp.float64)
mesh = make_scenario_mesh()
sharding = scenario_sharding(mesh)
B = 16

def row(i):
    return np.array([0.0, -math.pi / 2 + 0.01 * i, 0.0, 0.0])

x0s = jax.make_array_from_callback(
    (B, 4), sharding,
    lambda idx: np.stack([row(i) for i in range(*idx[0].indices(B))]),
)
sps = jax.make_array_from_callback(
    (B,), sharding,
    lambda idx: np.zeros(len(range(*idx[0].indices(B)))),
)
run = make_sharded_closed_loop(mpc, mesh, num_steps=5)
result, diag = run(x0s, dp, sps)
print(json.dumps({
    "proc": proc_id,
    "processes": jax.process_count(),
    "devices": len(jax.devices()),
    "instances": int(diag.n_instances),
    "failed": int(diag.n_failed),
    "max_violation": float(diag.max_violation),
}), flush=True)
jax.distributed.shutdown()
'''


@pytest.mark.skipif(
    os.environ.get("CARTPOLE_SKIP_MULTIPROC") == "1",
    reason="multi-process test disabled",
)
def test_two_process_sharded_closed_loop(tmp_path):
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = str(12300 + os.getpid() % 1000)

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, "-u", str(worker), str(i), "2", port, repo],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]

    reports = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                reports.append(json.loads(line))
    assert len(reports) == 2
    for r in reports:
        assert r["processes"] == 2
        assert r["devices"] == 8
        # psum'd diagnostics are identical and global on every process.
        assert r["instances"] == 16
        assert r["failed"] == 0
    assert reports[0]["max_violation"] == reports[1]["max_violation"]
