# Build tooling (reference parity: the upstream root Makefile that built the
# C solver and ran tests — SURVEY.md §2 "Build tooling").

.PHONY: all lib test test-all bench docs docs-torch clean

all: lib

lib:
	$(MAKE) -C csrc

test: lib
	python -m pytest tests/ -q -m "not slowtest"

# includes slow integration fits (parameter recovery / W1 parity)
test-all: lib
	python -m pytest tests/ -q

bench: lib
	python bench.py

# regenerate docs/cli_reference.md from the live argparse parsers
docs:
	python -m tcgan_tpu.utils.cli_docs

# regenerate docs/cli_reference_torch.md from the port's parsers
docs-torch:
	python -m tcgan_torch.utils.cli_docs

clean:
	$(MAKE) -C csrc clean
	rm -rf .pytest_cache tcgan_tpu/**/__pycache__ tests/__pycache__
