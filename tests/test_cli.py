"""CLI smoke tests — the ``model/scratch.py``-analog entry points."""

import json
import os
import pathlib
import subprocess
import sys

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _run(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "cartpole_tpu", *args],
        capture_output=True, text=True, timeout=400, env=env, cwd=REPO,
    )


class TestCli:
    def test_solve(self):
        res = _run("solve", "--cpu", "--params", '{"max_iterations": 3}')
        assert res.returncode == 0, res.stderr[-2000:]
        assert "termination" in res.stdout

    def test_closed_loop_with_log(self, tmp_path):
        log = tmp_path / "log.json"
        res = _run(
            "closed-loop", "--cpu", "--steps", "25",
            "--params", '{"max_iterations": 3}',
            "--log-json", str(log),
        )
        assert res.returncode == 0, res.stderr[-2000:]
        summary = json.loads(res.stdout.split("wrote")[0])
        assert summary["steps"] == 25
        assert summary["n_failed"] == 0
        entries = json.loads(log.read_text())
        assert len(entries) == 25
        assert set(entries[0]) == {"state", "u", "termination_state"}

    def test_closed_loop_schedule(self):
        """--schedule runs the time-varying-parameter phases
        (run_scheduled_closed_loop) and sizes the run from the phases."""
        res = _run(
            "closed-loop", "--cpu",
            "--params", '{"max_iterations": 2}',
            "--schedule",
            '[[3, {"u_derivative_cost_weight": 0.8}], [3, null]]',
        )
        assert res.returncode == 0, res.stderr[-2000:]
        summary = json.loads(res.stdout.split("wrote")[0])
        assert summary["steps"] == 6
        # Layout-changing overrides get the schedule API's designed error.
        res = _run(
            "closed-loop", "--cpu",
            "--params", '{"max_iterations": 2}',
            "--schedule", '[[3, {"window_length": 20}]]',
        )
        assert res.returncode != 0
        assert "decision-vector layout" in res.stderr

    def test_sweep(self):
        res = _run(
            "sweep", "--cpu", "--batch", "8", "--steps", "5",
            "--params", '{"max_iterations": 2}',
        )
        assert res.returncode == 0, res.stderr[-2000:]
        summary = json.loads(res.stdout)
        assert summary["batch"] == 8
        assert summary["n_failed_solves"] == 0
        # --layout auto: the lanes path for the (default) condensed KKT.
        assert summary["layout"] == "lanes"
        assert summary["platform"] == "cpu"
        assert summary["device_count"] == 8

    def test_sweep_auto_layout_is_vmap_for_lu(self):
        """--layout auto picks by kkt_method alone, on every backend."""
        res = _run(
            "sweep", "--cpu", "--batch", "8", "--steps", "2",
            "--params", '{"max_iterations": 2, "kkt_method": "lu"}',
        )
        assert res.returncode == 0, res.stderr[-2000:]
        summary = json.loads(res.stdout)
        assert summary["layout"] == "vmap"
        assert summary["device_kind"] == "cpu"

    def test_bad_params_rejected(self):
        res = _run("solve", "--cpu", "--params", '{"windowlength": 60}')
        assert res.returncode != 0
        assert "unknown OptimizationParams field" in (res.stderr + res.stdout)


class TestBenchScript:
    """The driver-facing benchmark contract (one JSON line)."""

    def _bench(self, *args):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py"), "--cpu",
             "--reps", "1", *args],
            capture_output=True, text=True, timeout=500, env=env, cwd=REPO,
        )

    def test_json_contract_and_upright_rounding(self):
        res = self._bench("--batch", "8", "--ticks", "7",
                          "--upright-ticks", "10")
        assert res.returncode == 0, res.stderr[-2000:]
        out = json.loads(res.stdout)
        assert out["metric"] == "batched_mpc_solves_per_s_per_chip"
        assert out["unit"] == "solves/s"
        assert out["layout"] == "lanes" and out["kkt_method"] == "condensed"
        # chunked continuation rounds UP to whole compiled programs
        assert out["upright_ticks"] == 14
        assert out["n_failed"] == 0
        assert (out["platform"], out["device_kind"]) == ("cpu", "cpu")
        assert out["device_count"] >= 1

    def test_no_accelerator_is_an_error_without_cpu_flag(self):
        """Without --cpu the bench measures a device or fails: it never
        falls back to the CPU."""
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        res = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py"), "--batch", "4"],
            capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
        )
        assert res.returncode != 0
        assert res.stdout.strip() == ""
        assert "no accelerator" in res.stderr

    def test_layout_label_reports_timed_path(self):
        """--kkt lu cannot use lanes; the JSON must say what actually ran."""
        res = self._bench("--batch", "4", "--ticks", "2", "--kkt", "lu",
                          "--no-upright")
        assert res.returncode == 0, res.stderr[-2000:]
        out = json.loads(res.stdout)
        assert out["kkt_method"] == "lu"
        assert out["layout"] == "vmap"
