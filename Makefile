# Developer entry points for the cartpole_tpu framework.
#
# The analog of the reference's dual-target CMake + ctest surface
# (/root/reference/CMakeLists.txt, optimization/CMakeLists.txt:82-93): one
# place that builds the native oracle, runs the test tiers, the lint wall,
# the benchmarks, and the codegen pipeline.

PY ?= python

.PHONY: test test-fast test-slow lint bench bench-sweep smoke codegen native clean help

help:
	@echo "targets: test test-fast test-slow lint bench bench-sweep smoke codegen native clean"

test:            ## the CI gate: per-file interpreter isolation (~40 min)
	$(PY) scripts/run_tests.py

test-fast:       ## single-process pytest (dev loops; can hit the
	## order-dependent XLA:CPU abort on big-AD files — CLAUDE.md)
	$(PY) -m pytest tests/ -q

test-slow:       ## adds the slow-marked extras
	CARTPOLE_SLOW_TESTS=1 $(PY) -m pytest tests/ -q

lint:            ## ruff (gates when installed) + the dependency-free lint wall
	@if command -v ruff >/dev/null 2>&1; then ruff check .; \
	else echo "ruff not installed; skipping (CI runs it)"; fi
	$(PY) scripts/lint.py

bench:           ## headline benchmark on the attached device (~6 min cold)
	$(PY) bench.py

bench-sweep:     ## batch/latency matrix -> bench_sweep.json
	$(PY) bench.py --sweep

smoke:           ## closed loop + reference checks on one NVIDIA GPU
	$(PY) chip_smoke.py

codegen:         ## regenerate the machine-generated dynamics modules
	$(PY) -m cartpole_tpu.symbolic.generate --version single --jacobians \
	    --out cartpole_tpu/models/_single_gen.py
	$(PY) -m cartpole_tpu.symbolic.generate --version double --jacobians \
	    --out cartpole_tpu/models/_double_gen.py

native:          ## build the C++ parity oracle (content-hash cached)
	$(PY) -c "from cartpole_tpu import native; print(native._build())"

clean:
	rm -rf build dist *.egg-info
	find . -name __pycache__ -prune -exec rm -rf {} +
