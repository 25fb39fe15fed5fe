"""Multi-host scale-out: process bring-up and host-sharded channel banks.

The reference's only multi-process story is Unix pipes on one machine
(SURVEY.md §2.9). The equivalent here spans hosts: each host ingests
its local channels' sample streams (over DCN/NICs, outside this library's
scope) and joins a global device mesh via ``jax.distributed``; the
(channel, time) mesh then spans all hosts' chips with channel shards
pinned host-locally so sample ingest never crosses DCN.
"""
from __future__ import annotations

import jax
import numpy as np

from .sharded import make_mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join (or bootstrap) a multi-host JAX runtime.

    With no arguments, relies on the environment (cluster metadata /
    JAX_COORDINATOR_ADDRESS). Single-host setups may skip this entirely.
    """
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_channel_mesh(n_time_shards: int = 1):
    """A (channel, time) mesh over every chip in the job, with channel
    shards enumerated host-major so each host's channels map to its own
    local devices (ingest stays off DCN; only halo/psum ride ICI)."""
    devices = jax.devices()
    return make_mesh(
        n_channel_shards=len(devices) // n_time_shards,
        n_time_shards=n_time_shards,
        devices=devices,
    )


def local_channel_slice(total_channels: int) -> slice:
    """Which rows of the global [channels, ...] arrays this host feeds."""
    n_proc = jax.process_count()
    pid = jax.process_index()
    per = total_channels // n_proc
    start = pid * per
    end = total_channels if pid == n_proc - 1 else start + per
    return slice(start, end)


def make_global_array(local_block: np.ndarray, mesh, spec):
    """Assemble a globally-sharded array from per-host local blocks
    (jax.make_array_from_process_local_data)."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_block)
