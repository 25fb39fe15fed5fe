"""Multi-chip sharding: the scale-out story (SURVEY.md §2.9 equivalents).

The reference scales by running one Unix process per channel
(examples/*.sh); the replacement here is a device mesh with axes

    (channel, time)

- **channel** is the data-parallel axis: a bank of independent RF channels
  shards embarrassingly; all per-channel state (RRC history, demod timing,
  frame machines) is local to its shard.
- **time** is the sequence-parallel axis for bulk/recorded workloads: one
  long capture splits along the sample axis. Convolutional stages need the
  trailing ``taps-1`` samples of the previous shard — an **overlap-save
  halo exchange** implemented with ``jax.lax.ppermute`` (NVLink between
  GPUs; SURVEY.md §5 long-context mapping).

Everything here is `shard_map` over an explicit Mesh, so XLA emits the
collectives; on a CPU host it runs identically over the virtual-device
mesh (tests/conftest.py forces 8 devices).
"""
from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..dsp.demod import demod_init, gfsk_demod_block
from ..dsp.rrc import WIDE_RRC, RrcDesign, RrcState, rrc_filter_block
from ..pipeline.dmr import dmr_decode_frames, dmr_sync_correlate
from ..protocols.dmr.phases import FRAME_SIZE


def make_mesh(n_channel_shards: int | None = None,
              n_time_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (channel, time) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_channel_shards is None:
        n_channel_shards = n // n_time_shards
    assert n_channel_shards * n_time_shards <= n
    dev_array = np.asarray(
        devices[:n_channel_shards * n_time_shards]
    ).reshape(n_channel_shards, n_time_shards)
    return Mesh(dev_array, axis_names=("channel", "time"))


def _halo_from_left(x: jnp.ndarray, halo: int, axis_name: str):
    """Pass each shard's trailing ``halo`` samples to its right neighbor;
    shard 0 receives zeros (stream start). x: [C_local, T_local]."""
    n = jax.lax.axis_size(axis_name)
    tail = x[:, -halo:]
    perm = [(i, i + 1) for i in range(n - 1)]
    left_tail = jax.lax.ppermute(tail, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    left_tail = jnp.where(idx == 0, jnp.zeros_like(left_tail), left_tail)
    return left_tail


def sharded_rrc_filter(mesh: Mesh, samples: jnp.ndarray,
                       design: RrcDesign = WIDE_RRC) -> jnp.ndarray:
    """Overlap-save RRC over a (channel, time)-sharded sample block.

    samples: [C, T] float32 (C divisible by channel shards, T by time
    shards). Output matches the single-device streaming filter run from
    zeroed state — the halo exchange provides exactly the ``taps-1``
    cross-shard history (block-size invariance is tested).
    """
    halo = design.ntaps - 1

    def local(x):
        left = _halo_from_left(x, halo, "time")
        xfull = jnp.concatenate([left, x], axis=-1)
        y, _ = rrc_filter_block(
            xfull[:, halo:], RrcState(xfull[:, :halo]), design)
        return y

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=P("channel", "time"),
        out_specs=P("channel", "time"),
    )
    return f(samples)


def sharded_pipeline_step(mesh: Mesh, samples: jnp.ndarray,
                          sps: int = 10, n_centuries: int = 2):
    """One full multi-chip DMR pipeline step, jit-compiled over the mesh.

    Axes in play:
    - channel-DP: every stage shards over the channel axis
    - time-SP: the RRC FIR runs overlap-save with a ppermute halo; the
      demod + frame decode run per time shard (bulk/recorded mode), and a
      psum over the time axis aggregates per-channel sync statistics —
      the collective pattern the production topology uses.

    samples: [C, T]; per time shard T_local must cover n_centuries
    centuries + lookahead: T_local >= n_centuries*(100*sps+1)+1.
    Returns (voice_payload [C, T?/144-ish, 27], sync_hits [C]) with
    leading axes sharded like the inputs.
    """
    design = WIDE_RRC
    halo = design.ntaps - 1

    def local(x):
        # ---- overlap-save RRC with a halo exchange ----
        left = _halo_from_left(x, halo, "time")
        y, _ = rrc_filter_block(
            jnp.concatenate([left, x], axis=-1)[:, halo:],
            RrcState(left), design)
        # ---- per-shard demod + batched frame decode ----
        c_local = y.shape[0]
        # fresh per-shard state is replicated from shard_map's viewpoint;
        # mark it device-varying so the scan carry types line up
        state0 = jax.tree.map(
            lambda a: jax.lax.pcast(a, ("channel", "time"), to="varying"),
            demod_init(c_local))
        dibits, _ = gfsk_demod_block(y, state0, n_centuries, sps)
        sync_dist = dmr_sync_correlate(dibits)
        n_frames = dibits.shape[1] // FRAME_SIZE
        frames = dibits[:, :n_frames * FRAME_SIZE].reshape(
            c_local, n_frames, FRAME_SIZE)
        fields = dmr_decode_frames(frames)
        # ---- cross-shard reduction over the time axis (psum) ----
        hits = jnp.sum((sync_dist <= 3).any(-1), axis=-1)
        total_hits = jax.lax.psum(hits, "time")
        return fields["voice_payload"], total_hits

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=P("channel", "time"),
        out_specs=(P("channel", "time", None), P("channel")),
        check_vma=False,  # the GPU demod's pallas_call has no vma rule
    )
    return jax.jit(f)(samples)


def sharded_fsk_step(mesh: Mesh, samples: jnp.ndarray,
                     protocol: str = "dstar",
                     n_centuries: int = 2):
    """Multi-chip step for the bit-domain (2FSK) protocols.

    Same axis roles as ``sharded_pipeline_step`` — channel-DP everywhere,
    time-SP in bulk/recorded mode with a psum over the time axis for the
    per-channel sync statistics — but no RRC stage (D-Star/POCSAG front
    ends feed the slicer directly, src/fsk_demodulator/).

    protocol "dstar": 10 sps; returns per-96-bit-frame voice bytes
    [C, F, 9] (LSB-first packed, dstar_phase.cpp:76-86) and psum'd
    voice/header-sync hit counts [C].
    protocol "pocsag": 40 sps inverted; returns per-32-bit-window BCH
    ok flags [C, W] and psum'd preamble hit counts [C].
    """
    from ..dsp.demod import fsk_demod_block
    from ..pipeline.fsk import (bit_sync_correlate, dstar_decode_frames,
                                pocsag_decode_frames)
    from ..protocols.dstar.phases import HEADER_SYNC, VOICE_SYNC
    from ..protocols.pocsag import SYNC_PATTERN
    if protocol == "dstar":
        sps, invert = 10, False
    elif protocol == "pocsag":
        sps, invert = 40, True
    else:
        raise ValueError(
            f"unknown 2FSK protocol {protocol!r} (dstar or pocsag)")

    def local(x):
        state0 = jax.tree.map(
            lambda a: jax.lax.pcast(a, ("channel", "time"), to="varying"),
            demod_init(x.shape[0]))
        bits, _ = fsk_demod_block(x, state0, n_centuries, sps, invert)
        if protocol == "dstar":
            hits = jnp.sum(
                (bit_sync_correlate(bits, HEADER_SYNC) <= 2)
                | (bit_sync_correlate(bits, VOICE_SYNC) <= 1), axis=-1)
            n = (bits.shape[1] - 24) // 96
            windows = jnp.stack(
                [bits[:, i * 96:i * 96 + 120] for i in range(n)], axis=1)
            fields = dstar_decode_frames(windows)
            out = fields["voice"]
        else:
            hits = jnp.sum(
                bit_sync_correlate(bits, SYNC_PATTERN) <= 3, axis=-1)
            n = bits.shape[1] // 32
            fields = pocsag_decode_frames(
                bits[:, :n * 32].reshape(bits.shape[0], n, 32))
            out = fields["ok"]
        return out, jax.lax.psum(hits, "time")

    out_spec = (P("channel", "time", None) if protocol == "dstar"
                else P("channel", "time"))
    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=P("channel", "time"),
        out_specs=(out_spec, P("channel")),
        check_vma=False,  # the GPU demod's pallas_call has no vma rule
    )
    return jax.jit(f)(samples)


def _gfsk_config(protocol: str):
    """(rrc design, sps, frame size, sync correlate, frame decode) for the
    three 4FSK protocols. Lazy imports keep module load light."""
    if protocol == "dmr":
        return (WIDE_RRC, 10, FRAME_SIZE, dmr_sync_correlate,
                dmr_decode_frames)
    if protocol == "ysf":
        from ..pipeline.ysf import ysf_decode_frames, ysf_sync_correlate
        from ..protocols.ysf.phases import FRAME_SIZE as YSF_FRAME
        return WIDE_RRC, 10, YSF_FRAME, ysf_sync_correlate, ysf_decode_frames
    if protocol == "nxdn":
        from ..dsp.rrc import NARROW_RRC
        from ..pipeline.nxdn import (nxdn_decode_frames,
                                     nxdn_sync_correlate)
        from ..protocols.nxdn.phases import FRAME_SIZE as NXDN_FRAME
        return (NARROW_RRC, 20, NXDN_FRAME, nxdn_sync_correlate,
                nxdn_decode_frames)
    raise ValueError(f"unknown 4FSK protocol {protocol!r}")


def sharded_gfsk_step(mesh: Mesh, samples: jnp.ndarray,
                      protocol: str = "dmr", n_centuries: int = 2):
    """Generalized multi-chip 4FSK pipeline step: DMR, YSF, or NXDN.

    Same mesh pattern as :func:`sharded_pipeline_step` (which remains the
    DMR-specific entry point): channel-DP everywhere, overlap-save RRC
    with a ppermute halo over the time axis (NXDN exchanges the narrow
    design's 160-sample halo — rrc_filter.cpp:39-84), per-shard demod +
    batched frame-field decode, psum'd sync statistics.

    samples: [C, T] float32. Returns (fields dict with [C, F_total, ...]
    arrays sharded (channel, time), sync_hits [C]).
    """
    design, sps, frame_size, sync_fn, decode_fn = _gfsk_config(protocol)
    halo = design.ntaps - 1

    def local(x):
        left = _halo_from_left(x, halo, "time")
        y, _ = rrc_filter_block(
            jnp.concatenate([left, x], axis=-1)[:, halo:],
            RrcState(left), design)
        c_local = y.shape[0]
        state0 = jax.tree.map(
            lambda a: jax.lax.pcast(a, ("channel", "time"), to="varying"),
            demod_init(c_local))
        dibits, _ = gfsk_demod_block(y, state0, n_centuries, sps)
        sync_dist = sync_fn(dibits)
        n_frames = dibits.shape[1] // frame_size
        frames = dibits[:, :n_frames * frame_size].reshape(
            c_local, n_frames, frame_size)
        fields = decode_fn(frames)
        hit = sync_dist <= 3
        hits = jnp.sum(hit.reshape(c_local, -1), axis=-1)
        return fields, jax.lax.psum(hits, "time")

    struct = jax.eval_shape(
        decode_fn,
        jax.ShapeDtypeStruct((1, 1, frame_size), jnp.uint8))
    out_specs = (jax.tree.map(lambda _: P("channel", "time"), struct),
                 P("channel"))
    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=P("channel", "time"),
        out_specs=out_specs,
        check_vma=False,  # the GPU demod's pallas_call has no vma rule
    )
    return jax.jit(f)(samples)
