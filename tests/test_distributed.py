"""Multi-process jax.distributed validation (VERDICT round-1 item 4).

Spawns two real OS processes that join one jax.distributed CPU runtime
(coordinator on localhost), build the global (channel, time) mesh,
assemble a global sample array from per-host channel rows, run the
sharded DMR pipeline step, and verify the gathered outputs equal the
single-device reference — exercising process bring-up, host-local
channel slicing, make_array_from_process_local_data, and cross-process
collectives (Gloo), all without accelerator hardware.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_step():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(_WORKER))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"DIST-OK pid {pid}" in out, out
