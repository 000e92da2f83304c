.PHONY: install lint type-check format format-check test test-torch coverage bench run

install:
	pip install -e .

lint:
	flake8 pararealml_tpu pararealml_tpu_torch tests chip_smoke.py

type-check:
	mypy pararealml_tpu

format:
	black pararealml_tpu tests examples
	isort pararealml_tpu tests examples

format-check:
	black --check pararealml_tpu tests examples
	isort --check pararealml_tpu tests examples

test:
	python -m pytest -v tests/

# the PyTorch port's CPU tests (held against the JAX package); on a GPU
# machine, `python3 chip_smoke.py` drives the port's kernels
test-torch:
	python -m pytest -q tests/test_torch_*.py

# the CI-viable subset: skips tests marked slow, parallelized over all
# cores (the full suite takes ~20 minutes on 8 workers)
test-fast:
	python -m pytest -q -n auto -m "not examples and not slow" tests/

# end-to-end smoke runs of every example script (PRML_SMOKE scaling)
test-examples:
	python -m pytest -q -n auto -m examples tests/test_examples.py

# the quality gate the reference delegates to SonarCloud
# (/root/reference/.github/workflows/build.yml:24-39): coverage is
# computed over the full suite and the build fails if it regresses
# below the floor
COV_FLOOR = 85

coverage:
	python -m pytest -q -n auto --cov=pararealml_tpu \
		--cov-report=xml --cov-report=term \
		--cov-fail-under=$(COV_FLOOR) tests/

bench:
	python bench.py

# Runs an example, e.g. `make run example=lorenz_ode`.
# Unlike the reference's mpiexec launcher, time parallelism needs no
# process fan-out: the Parareal operator shards over all visible
# devices inside one program.
run:
	cd examples && python $(example).py
