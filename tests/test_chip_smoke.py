"""chip_smoke.py: refuses to run without a GPU, and its checks hold.

On the CPU the same check functions the card runs are exercised at small
sizes (the demod kernel in interpret mode, everything else on the plain
path). The ``gpu``-marked cases run them at full width and skip here.
"""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCRIPT = os.path.join(ROOT, "chip_smoke.py")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _ok_lines(stdout):
    return [ln for ln in stdout.splitlines()
            if ln.startswith("{") and '"ok"' in ln]


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_cpu_run_exits_nonzero_without_result(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, SCRIPT] + argv, env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _ok_lines(r.stdout) == []
    assert "no GPU" in r.stderr


def test_lone_script_fails(tmp_path):
    """Copied into a directory holding nothing else of the repo."""
    shutil.copy(SCRIPT, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert _ok_lines(r.stdout) == []


@pytest.mark.parametrize("protocol",
                         ["dmr", "ysf", "nxdn", "dstar", "pocsag"])
def test_e2e_protocol_small(protocol):
    r = chip_smoke.e2e_protocol(protocol, channels=16, seconds=1.0,
                                centuries=4)
    assert r["keyed"] == 2 and r["noise_channels_checked"] == 14
    assert r["expected_bytes"] > 0
    assert r["missing_bytes"] <= 2 * chip_smoke._frame_bytes(protocol)


def test_e2e_dmr_iq_small():
    r = chip_smoke.e2e_dmr_iq(channels=8, seconds=1.0, centuries=2)
    assert r["iq_symbols_equal"] and r["keyed"] == 1


@pytest.mark.parametrize("sps,mode,invert", [
    (10, "gfsk", False), (20, "gfsk", False), (40, "fsk", True),
    (10, "fsk", False)])
@pytest.mark.parametrize("clean", [False, True])
def test_demod_parity_interpret(sps, mode, invert, clean):
    agree, oracle = chip_smoke.demod_parity(
        4, 2, sps, mode, invert, clean, interpret=True, oracle_channels=2)
    if clean:
        assert agree == 1.0 and oracle == 1.0


def test_rrc_parity_small():
    assert chip_smoke.rrc_parity(channels=4, T=1024, oracle_channels=1,
                                 oracle_len=512) <= 1e-5


def test_integer_parity_small():
    assert chip_smoke.integer_parity(channels=8)


def test_compile_all_small():
    r = chip_smoke.compile_all(channels=8, centuries=2)
    assert set(r["first_call_s"]) == {"dmr", "ysf", "nxdn", "dstar",
                                      "pocsag"}


def test_serving_parity_small():
    r = chip_smoke.serving_parity(channels=4, seconds=0.5, centuries=2)
    assert r["workers"] == 2 and r["bytes"] > 0


def test_mesh_parity_virtual_devices():
    import jax

    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs the virtual CPU mesh")
    assert chip_smoke.mesh_parity(devices[:4], channels=8, seconds=0.5,
                                  centuries=2)["devices"] == 4


def test_timesharded_parity_virtual_devices():
    import jax

    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs the virtual CPU mesh")
    r = chip_smoke.timesharded_parity(devices[:4], channels=16,
                                      seconds=6.5)
    assert r["time_shards"] == 4 and r["keyed"] == 2
    assert r["sharded_steps"] >= 2


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_the_cpu_in_process(capsys, monkeypatch, argv):
    """main() returns non-zero before any phase and prints no result."""
    # main() sets this process's memory share; undo it after the test
    monkeypatch.delenv("XLA_PYTHON_CLIENT_MEM_FRACTION", raising=False)
    assert chip_smoke.main(argv) == 1
    assert _ok_lines(capsys.readouterr().out) == []


@pytest.mark.gpu
@pytest.mark.parametrize("sps", [10, 20, 40])
def test_demod_kernel_parity_on_gpu(gpu, sps):
    for mode, invert in (("gfsk", False), ("fsk", False), ("fsk", True)):
        for clean in (False, True):
            chip_smoke.demod_parity(chip_smoke.CHANNELS,
                                    chip_smoke.CENTURIES, sps, mode,
                                    invert, clean)


@pytest.mark.gpu
def test_kernel_ab_on_gpu(gpu):
    res = chip_smoke.kernel_ab()
    assert all(v > 0 for r in res.values() for v in r.values())
