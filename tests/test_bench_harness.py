"""bench.py: one process, GPU or a structured failure.

The contract under test: ``python bench.py`` prints exactly one
parseable JSON line naming the device it found, and without a GPU it
fails (exit 2) instead of timing the CPU.
"""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.join(os.path.dirname(__file__), "..", "bench.py")


def _json_lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def test_no_gpu_fails_with_one_json_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, BENCH], env=env, timeout=300,
                       capture_output=True, text=True)
    assert r.returncode == 2, r.stderr[-800:]
    lines = _json_lines(r.stdout)
    assert len(lines) == 1
    out = lines[0]
    assert out["value"] is None
    assert out["metric"] == "dmr_iq_pipeline_throughput"
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] >= 1
    assert "GPU" in out["error"]


def _bench_module():
    sys.path.insert(0, os.path.dirname(BENCH))
    import bench
    return bench


def test_summarize_uses_the_median_step():
    bench = _bench_module()
    out = bench.summarize([0.002, 0.001, 0.010], channels=256,
                          samples_per_step=16000,
                          frame_windows_per_step=256 * 11)
    assert out["per_step_seconds"] == 0.002
    assert out["value"] == pytest.approx(256 * 16000 / 0.002 / 1e6)
    assert out["vs_baseline"] == pytest.approx(out["value"] / 0.048)
    assert out["step_seconds_min"] == 0.001
    assert out["step_seconds_max"] == 0.010
    assert out["frame_windows_decoded_per_s"] == pytest.approx(
        256 * 11 / 0.002)


def test_card_line_never_raises():
    bench = _bench_module()
    assert isinstance(bench.card_line(), str)
