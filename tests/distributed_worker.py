"""Worker process for tests/test_distributed.py.

Joins a 2-process jax.distributed CPU runtime (4 virtual devices per
process -> 8 global), builds the global (channel, time) mesh, assembles a
global sample array from process-local channel rows, runs the sharded
DMR pipeline step, and checks this host's addressable output shards
against a locally-computed single-device reference.

Usage: python distributed_worker.py <process_id> <coordinator_port>
"""
import os
import sys

PID = int(sys.argv[1])
PORT = sys.argv[2]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                           num_processes=2, process_id=PID)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from digiham_jax.parallel.distributed import (  # noqa: E402
    global_channel_mesh,
    local_channel_slice,
    make_global_array,
)
from digiham_jax.parallel import sharded_pipeline_step  # noqa: E402
from digiham_jax.dsp.demod import demod_init, gfsk_demod_block  # noqa: E402
from digiham_jax.dsp.rrc import (WIDE_RRC, RrcState,  # noqa: E402
                                 rrc_filter_block)
from digiham_jax.pipeline.dmr import (dmr_decode_frames,  # noqa: E402
                                      dmr_sync_correlate)
from digiham_jax.protocols.dmr.phases import FRAME_SIZE  # noqa: E402

assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

N_TIME = 2
mesh = global_channel_mesh(n_time_shards=N_TIME)
assert mesh.shape == {"channel": 4, "time": N_TIME}, mesh.shape

C, n_cent, sps = 4, 1, 10
T_local = n_cent * (100 * sps + 1) + 1
rng = np.random.default_rng(0)  # same stream in both processes
x_global = rng.normal(0, 500, (C, N_TIME * T_local)).astype(np.float32)

rows = local_channel_slice(C)
assert rows == slice(PID * 2, (PID + 1) * 2), rows
arr = make_global_array(x_global[rows], mesh, P("channel", "time"))
assert arr.shape == x_global.shape, arr.shape

voice, hits = sharded_pipeline_step(mesh, arr, sps, n_cent)
jax.block_until_ready((voice, hits))

# single-device local reference for ALL rows (cheap at this size)
y_full, _ = rrc_filter_block(
    jnp.asarray(x_global), RrcState.init(C, WIDE_RRC), WIDE_RRC)
want_hits = np.zeros(C, np.int64)
want_voice = []
for t in range(N_TIME):
    ys = y_full[:, t * T_local:(t + 1) * T_local]
    dibits, _ = gfsk_demod_block(ys, demod_init(C), n_cent, sps)
    sync_dist = np.asarray(dmr_sync_correlate(dibits))
    want_hits += ((sync_dist <= 3).any(-1)).sum(-1)
    n = dibits.shape[1] // FRAME_SIZE
    frames = dibits[:, :n * FRAME_SIZE].reshape(C, n, FRAME_SIZE)
    want_voice.append(np.asarray(dmr_decode_frames(frames)["voice_payload"]))
want_voice = np.concatenate(want_voice, axis=1)

for s in voice.addressable_shards:
    np.testing.assert_array_equal(np.asarray(s.data),
                                  want_voice[s.index])
for s in hits.addressable_shards:
    np.testing.assert_array_equal(np.asarray(s.data), want_hits[s.index])

print(f"DIST-OK pid {PID}", flush=True)
