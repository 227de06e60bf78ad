# Convenience targets (see README.md).
test:
	python -m pytest tests/ -q

test-slow:
	python -m pytest tests/ -q -m "slow or not slow"

bench:
	python bench.py

smoke:
	python chip_smoke.py

configs:
	python scripts/run_configs.py --quick

serve:
	python -m montecarlo_tpu

native:
	$(MAKE) -C native

.PHONY: test test-slow bench smoke configs serve native
