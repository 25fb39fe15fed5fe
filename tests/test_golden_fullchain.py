"""Full-chain golden: impaired RF samples through the COMPLETE stack —
reference ``dsp_harness`` demod -> ``ref_harness`` decoder vs our fused
device pipeline -> TrackedChannelBank — byte-compared (payload + meta).
Thin in-suite version of tools/fuzz_fullchain.py (fixed seeds)."""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

HARNESS_DIR = os.path.join(os.path.dirname(__file__), "ref_harness")


# only these tests run the reference binaries: skip, not error, when
# the reference source tree is absent (tests/conftest.py)
pytestmark = pytest.mark.usefixtures("ref_harness")


@pytest.mark.parametrize("seed", [64000, 64001, 64002, 64010, 64011,
                                  64012, 64020, 64021, 64022])
def test_fullchain_matches_reference(seed, monkeypatch):
    from tools import fuzz_fullchain as fc

    monkeypatch.setattr(fc, "DSP", os.path.join(HARNESS_DIR,
                                                "dsp_harness"))
    monkeypatch.setattr(fc, "REF", os.path.join(HARNESS_DIR,
                                                "ref_harness"))
    rng = np.random.default_rng(seed)
    proto = fc.PROTOCOLS[seed % len(fc.PROTOCOLS)]
    clean, sps = fc.synth(proto, rng)
    samples = fc.impair(rng, clean, sps)
    if proto == "dmr":
        p = subprocess.run([fc.DSP, "rrc"], input=samples.tobytes(),
                           capture_output=True, timeout=300)
        assert p.returncode == 0
        samples = np.frombuffer(p.stdout, np.float32)
    chunk = int(rng.integers(4096, 32768))
    got, meta = fc.our_chain(proto, samples, chunk)
    ref, ref_meta = fc.ref_chain(fc.DEMOD_ARGS[proto], proto, samples)
    assert got == ref, f"{proto} payload diverges"
    if proto != "pocsag":
        assert meta == ref_meta, f"{proto} metadata diverges"
