"""Test configuration: pin the CPU backend with an 8-device virtual mesh
so sharding tests run without accelerators, and provide the fixture that
decides GPU presence for the ``gpu``-marked tests."""
import os

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless jax's default device is a GPU. Decided when a test
    runs, never at import or collection, so every xdist worker collects
    the same tests."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return jax.devices()[0]


HARNESS_DIR = os.path.join(os.path.dirname(__file__), "ref_harness")


def _reference_tree() -> str:
    """The reference source tree the harness builds from: the REF
    variable of tests/ref_harness/Makefile."""
    with open(os.path.join(HARNESS_DIR, "Makefile")) as f:
        for line in f:
            if line.startswith("REF :="):
                return line.split(":=", 1)[1].strip()
    raise AssertionError("tests/ref_harness/Makefile defines no REF")


@pytest.fixture(scope="session")
def ref_harness():
    """Build the compiled-reference oracle (tests/ref_harness) and return
    its directory; skip when the reference source tree is absent, so
    only the tests that run the reference binaries depend on it."""
    import subprocess

    ref = _reference_tree()
    if not os.path.isdir(ref):
        pytest.skip(f"reference source tree {ref} is absent: the "
                    f"compiled-reference oracle cannot be built")
    r = subprocess.run(["make", "-s", "ref_harness", "dsp_harness"],
                       cwd=HARNESS_DIR, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return HARNESS_DIR
