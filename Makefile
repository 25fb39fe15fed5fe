# Build/packaging entry points (the reference ships a CMake shared lib +
# three Debian packages, CMakeLists.txt:7 / debian/control:11-31; the
# equivalent here is a pip wheel with the ten CLI entry points plus
# the on-demand-compiled native helper library). See docs/PACKAGING.md.

PYTHON ?= python
WHEELDIR ?= dist

.PHONY: wheel native cmake-package test bench smoke clean

wheel:
	$(PYTHON) -m pip wheel . --no-deps --no-build-isolation -w $(WHEELDIR)

native:
	$(PYTHON) -c "from digiham_jax import native; native._build(); print('native helpers:', 'loaded' if native._load() is not None else 'numpy fallback')"

# distro-consumable CMake package of the native host runtime
# (find_package(DigihamTpuNative) for C/C++ consumers; see docs/PACKAGING.md)
cmake-package:
	cmake -S digiham_jax/native -B build/native -DCMAKE_BUILD_TYPE=Release
	cmake --build build/native -j
	@echo "install with: cmake --install build/native --prefix <prefix>"

test:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/ -q

bench:
	$(PYTHON) bench.py

smoke:
	$(PYTHON) chip_smoke.py

warm-cache:
	$(PYTHON) tools/warm_cli_cache.py

bench-cpu-ref:
	$(PYTHON) tools/bench_cpu_vs_ref.py

fuzz:
	$(PYTHON) tools/fuzz_tracked.py 500 $$RANDOM
	$(PYTHON) tools/fuzz_fullchain.py 100 $$RANDOM
	$(PYTHON) tools/fuzz_timesharded.py 50 $$RANDOM

clean:
	rm -rf $(WHEELDIR) build *.egg-info
