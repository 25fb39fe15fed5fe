"""Streaming time-parallelism with an EXACT cross-shard carry chain.

``sharded_pipeline_step`` (sharded.py) is bulk mode: each time shard
demodulates from a fresh state, fine for recorded archives but not
bit-exact for a continuous stream. This module is the streaming mode the
SURVEY §5 long-context mapping calls for: the demodulator's O(1) carry
(pos / pending slew / volume ring — fsk_demodulator.cpp:37,84-87) threads
through the time shards over ICI, so a time-sharded stream decodes
byte-identically to the single-device pipeline step chain — for ALL five
protocols (the reference's O(1) stream state applies to every chain, and
the carry semantics are protocol-independent: only sps, the RRC design,
the sync patterns, and the frame decode differ).

How the axes parallelize — and what provably cannot:

- **RRC FIR** (81/161 MACs/sample — the bulk of per-sample FLOPs): fully
  time-parallel via overlap-save; each shard pulls its left raw halo from
  its neighbor with one ``ppermute`` (``taps-1`` + drift-budget samples).
  NXDN exchanges the narrow design's 160-sample halo
  (rrc_filter.cpp:39-84); the 2FSK protocols (D-Star, POCSAG) run no RRC
  and exchange only the drift-budget halo.
- **Sync correlation + frame-field FEC decode**: fully time-parallel on
  the decoded symbol segments (a ``sync_len-1`` symbol right halo covers
  windows that straddle shard boundaries).
- **The demod carry itself is a true sequential dependency**: symbol
  ``n``'s sample window position depends on every ±1 timing slew before
  it (the cumulative sum of data-dependent offsets), so no schedule can
  compute shard ``t+1``'s symbols before shard ``t``'s carry exists —
  the reference's own feedback loop (fsk_demodulator.cpp:36-78) forbids
  time-parallel demodulation with bit-exactness. The step therefore runs
  the demod as a **ppermute ring pipeline**: a ``fori_loop`` of
  ``n_time`` rounds in which the carry hops shard ``i -> i+1`` as soon
  as shard ``i``'s segment is demodulated, each shard starting its
  segment the moment the boundary carry lands. Demod wall-clock equals
  the single-device scan (Amdahl's sequential term); everything around
  it gets the ``n_time``-way speedup. The final hop ``T-1 -> 0`` lands
  the stream carry where the *next* step's first segment needs it — the
  software pipelining across successive steps.

Semantics contract (tested in tests/test_streaming_shards.py): for any
number of time shards and any number of consecutive steps, the symbol
stream, every dense sync-distance stream (valid region) and every decoded
frame field are byte-identical to the single-device pipeline stream.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..dsp.demod import (CENTURY, DemodState, demod_init, fsk_demod_block,
                         gfsk_demod_block)
from ..dsp.rrc import RrcDesign, RrcState, WIDE_RRC, rrc_filter_block


@dataclasses.dataclass(frozen=True)
class _SyncSpec:
    """One dense sync-correlation output of a pipeline step."""
    name: str               # output key (matches the single-device step)
    fn: Callable            # symbols [C, T] -> distances [C, T-length+1, ...]
    length: int             # correlation window in symbols


@dataclasses.dataclass(frozen=True)
class _ProtocolConfig:
    kind: str                       # "gfsk" (dibits) | "fsk" (bits)
    sps: int
    design: RrcDesign | None        # None = no RRC stage possible
    invert: bool
    frame_size: int | None          # symbols per decoded frame (None = none)
    decode_fn: Callable | None      # [C, F, frame_size] -> fields dict
    syncs: tuple[_SyncSpec, ...]
    cps_quantum: int                # centuries_per_shard alignment
    default_cps: int


def _protocol_config(protocol: str) -> _ProtocolConfig:
    """Per-protocol pieces, mirroring each single-device ``*Pipeline.step``
    (the byte-identity reference) — the same table sharded.py::_gfsk_config
    encodes for bulk mode."""
    if protocol == "dmr":
        from ..pipeline.dmr import dmr_decode_frames, dmr_sync_correlate
        from ..protocols.dmr.phases import FRAME_SIZE, SYNC_SIZE
        return _ProtocolConfig(
            "gfsk", 10, WIDE_RRC, False, FRAME_SIZE, dmr_decode_frames,
            (_SyncSpec("sync_dist_dense", dmr_sync_correlate, SYNC_SIZE),),
            cps_quantum=36, default_cps=36)
    if protocol == "ysf":
        from ..pipeline.ysf import ysf_decode_frames, ysf_sync_correlate
        from ..protocols.ysf.phases import FRAME_SIZE, SYNC_SIZE
        return _ProtocolConfig(
            "gfsk", 10, WIDE_RRC, False, FRAME_SIZE, ysf_decode_frames,
            (_SyncSpec("sync_dist_dense", ysf_sync_correlate, SYNC_SIZE),),
            cps_quantum=24, default_cps=24)
    if protocol == "nxdn":
        from ..dsp.rrc import NARROW_RRC
        from ..pipeline.nxdn import nxdn_sync_correlate
        from ..protocols.nxdn.phases import SYNC_SIZE
        # NxdnPipeline.step emits no frame fields (the tracked bank
        # decodes SACCH/FACCH host-gated); match its output contract
        return _ProtocolConfig(
            "gfsk", 20, NARROW_RRC, False, None, None,
            (_SyncSpec("sync_dist_dense", nxdn_sync_correlate, SYNC_SIZE),),
            cps_quantum=1, default_cps=16)
    if protocol == "dstar":
        from ..pipeline.fsk import bit_sync_correlate
        from ..protocols.dstar.phases import HEADER_SYNC, VOICE_SYNC
        return _ProtocolConfig(
            "fsk", 10, None, False, None, None,
            (_SyncSpec("sync_dist_header_sync",
                       functools.partial(bit_sync_correlate,
                                         pattern=HEADER_SYNC),
                       len(HEADER_SYNC)),
             _SyncSpec("sync_dist_voice_sync",
                       functools.partial(bit_sync_correlate,
                                         pattern=VOICE_SYNC),
                       len(VOICE_SYNC))),
            cps_quantum=1, default_cps=16)
    if protocol == "pocsag":
        from ..pipeline.fsk import bit_sync_correlate
        from ..protocols.pocsag import SYNC_PATTERN
        return _ProtocolConfig(
            "fsk", 40, None, True, None, None,
            (_SyncSpec("sync_dist_preamble",
                       functools.partial(bit_sync_correlate,
                                         pattern=SYNC_PATTERN),
                       len(SYNC_PATTERN)),),
            cps_quantum=1, default_cps=8)
    raise ValueError(f"unknown protocol {protocol!r}")


def _ct_spec(ndim: int) -> P:
    """Leading (channel, time-concat) axes, trailing replicated."""
    return P(*(("channel", "time") + (None,) * (ndim - 2)))


class TimeShardedPipeline:
    """(channel, time)-sharded streaming pipeline step, any protocol.

    Differences from the single-device ``*Pipeline`` classes:

    - fixed-length steps: every step demodulates exactly
      ``block_len = n_time * centuries_per_shard * 100 * sps`` samples
      per channel from the carried ``pos``; the per-channel ±1/century
      timing drift accumulates in the returned ``pos``. ``drift_budget``
      bounds |pos| at every segment start (halo headroom). Its default,
      ``n_time * centuries_per_shard``, is the most the timing can move
      in one step, so a step that starts at ``pos == 0`` — as
      :meth:`drive` arranges for every channel — can never leave it.
    - the caller supplies ``edges``: the ``h_left`` raw samples before
      the block and ``h_right`` after it (the stream driver keeps the
      tail / waits for the lookahead).

    Where the protocol decodes frame fields on device (DMR, YSF),
    ``centuries_per_shard`` must keep segments frame-aligned
    (``centuries_per_shard * 100 % frame_size == 0`` — multiples of 36
    for DMR's 144, of 24 for YSF's 480) so each shard's frame decode
    matches the single-device frame slicing.
    """

    def __init__(self, mesh: Mesh, channels: int, protocol: str = "dmr",
                 sps: int | None = None,
                 centuries_per_shard: int | None = None,
                 use_rrc: bool = True, drift_budget: int | None = None):
        if "time" not in mesh.axis_names or "channel" not in mesh.axis_names:
            raise ValueError("mesh needs ('channel', 'time') axes")
        cfg = _protocol_config(protocol)
        self.cfg = cfg
        self.protocol = protocol
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        self.channels = channels
        self.sps = cfg.sps if sps is None else sps
        if centuries_per_shard is None:
            centuries_per_shard = cfg.default_cps
        self.centuries_per_shard = centuries_per_shard
        self.use_rrc = use_rrc and cfg.design is not None
        if drift_budget is None:
            drift_budget = self.n_time * centuries_per_shard
        self.drift_budget = drift_budget
        self.seg_symbols = centuries_per_shard * CENTURY
        if cfg.frame_size and self.seg_symbols % cfg.frame_size:
            raise ValueError(
                f"centuries_per_shard={centuries_per_shard} leaves segments "
                f"frame-misaligned ({self.seg_symbols} % {cfg.frame_size} "
                f"!= 0); use a multiple of {cfg.cps_quantum}")
        self.seg_len = self.seg_symbols * self.sps
        self.block_len = self.n_time * self.seg_len
        self.symbols_per_block = self.n_time * self.seg_symbols
        # total centuries per step (TrackedChannelBank sizing contract)
        self.n_centuries = self.n_time * centuries_per_shard
        nt1 = cfg.design.ntaps - 1 if self.use_rrc else 0
        self.h_left = nt1 + drift_budget
        self.h_right = drift_budget + centuries_per_shard + 2
        self._step = self._build()

    def init_state(self) -> DemodState:
        return demod_init(self.channels)

    # ------------------------------------------------------------------
    def _build(self):
        cfg = self.cfg
        sps = self.sps
        n_cent = self.centuries_per_shard
        D = self.drift_budget
        HL, HR = self.h_left, self.h_right
        seg_len, seg_sym = self.seg_len, self.seg_symbols
        use_rrc = self.use_rrc
        nt1 = cfg.design.ntaps - 1 if cfg.design is not None else 0
        T = self.n_time
        max_sync = max(s.length for s in cfg.syncs)

        def local(x, edges, st_in):
            # x: [C_local, seg_len] raw samples of this shard's segment
            # edges: [C_local, HL+HR] block-edge raw samples (replicated
            #   over time; only shard 0 / T-1 read their half)
            # st_in: demod carry, pos relative to segment-0 origin
            t = jax.lax.axis_index("time")
            C = x.shape[0]
            fwd = [(i, i + 1) for i in range(T - 1)]
            bwd = [(i + 1, i) for i in range(T - 1)]

            # ---- raw-sample halo exchange over ICI ----
            if T > 1:
                left = jax.lax.ppermute(x[:, -HL:], "time", fwd)
                right = jax.lax.ppermute(x[:, :HR], "time", bwd)
            else:
                left = jnp.zeros((C, HL), x.dtype)
                right = jnp.zeros((C, HR), x.dtype)
            left = jnp.where(t == 0, edges[:, :HL], left)
            right = jnp.where(t == T - 1, edges[:, HL:], right)
            xe = jnp.concatenate([left, x, right], axis=-1)

            # ---- RRC: time-parallel overlap-save (exact w/ halo) ----
            if use_rrc:
                y, _ = rrc_filter_block(
                    xe[:, nt1:], RrcState(xe[:, :nt1]), cfg.design)
            else:
                y = xe
            # y[0] = filtered stream sample (segment_origin - D)

            # ---- demod: sequential ppermute ring pipeline ----
            ring = [(i, (i + 1) % T) for i in range(T)]

            def round_(i, carry):
                st, dib = carry
                # pos arrives relative to this shard's segment origin;
                # y starts D samples earlier
                st_loc = DemodState(st.pos + D, st.offset, st.volume_ring)
                if cfg.kind == "gfsk":
                    d_i, st_out = gfsk_demod_block(y, st_loc, n_cent, sps)
                else:
                    d_i, st_out = fsk_demod_block(y, st_loc, n_cent, sps,
                                                  cfg.invert)
                # rebase the carry to the NEXT segment's origin before
                # the hop (the wrap hop T-1 -> 0 then lands it already
                # rebased for the next step's first segment)
                st_out = DemodState(st_out.pos - D - seg_len,
                                    st_out.offset, st_out.volume_ring)
                dib = jnp.where(t == i, d_i, dib)
                if T > 1:
                    st_out = jax.tree.map(
                        lambda a: jax.lax.ppermute(a, "time", ring), st_out)
                return st_out, dib

            st0 = jax.tree.map(
                lambda a: jax.lax.pcast(a, "time", to="varying"), st_in)
            dib0 = jax.lax.pcast(
                jnp.zeros((C, seg_sym), jnp.uint8), ("channel", "time"),
                to="varying")
            st_fin, dibits = jax.lax.fori_loop(0, T, round_, (st0, dib0))

            # ---- sync correlation: time-parallel with a symbol halo ----
            if T > 1:
                dh = jax.lax.ppermute(
                    dibits[:, :max_sync - 1], "time", bwd)
            else:
                dh = jnp.zeros((C, max_sync - 1), dibits.dtype)
            dh = jnp.where(t == T - 1, jnp.zeros_like(dh), dh)
            padded = jnp.concatenate([dibits, dh], axis=-1)
            win = jnp.arange(seg_sym)
            outputs = {"dibits": dibits}
            for s in cfg.syncs:
                dist = s.fn(padded)[:, :seg_sym]
                # the final shard's last sync_len-1 windows have no
                # symbols yet: mark invalid (the driver exposes only the
                # valid region)
                invalid = (t == T - 1) & (win > seg_sym - s.length)
                inv = invalid.reshape((1, seg_sym) + (1,) * (dist.ndim - 2))
                outputs[s.name] = jnp.where(inv, 99, dist)

            # ---- frame-field decode: time-parallel ----
            if cfg.frame_size:
                frames = dibits.reshape(
                    C, seg_sym // cfg.frame_size, cfg.frame_size)
                outputs.update(cfg.decode_fn(frames))

            # carry out: one column per shard; after the wrap hop the true
            # stream carry sits on shard 0 — the host reads column 0
            st_cols = jax.tree.map(
                lambda a: a[:, None] if a.ndim == 1 else a[:, None, :],
                st_fin)
            return outputs, st_cols

        out_shapes = {"dibits": 2}
        probe = jax.ShapeDtypeStruct(
            (1, seg_sym + max_sync - 1), jnp.uint8)
        for s in cfg.syncs:
            out_shapes[s.name] = jax.eval_shape(s.fn, probe).ndim
        if cfg.frame_size:
            fields = jax.eval_shape(
                cfg.decode_fn,
                jax.ShapeDtypeStruct((1, 1, cfg.frame_size), jnp.uint8))
            out_shapes.update({k: v.ndim for k, v in fields.items()})
        out_specs = (
            {k: _ct_spec(nd) for k, nd in out_shapes.items()},
            DemodState(pos=_ct_spec(2), offset=_ct_spec(2),
                       volume_ring=_ct_spec(3)),
        )
        in_specs = (
            P("channel", "time"),
            P("channel", None),
            DemodState(pos=P("channel"), offset=P("channel"),
                       volume_ring=P("channel", None)),
        )
        f = jax.shard_map(local, mesh=self.mesh,
                          in_specs=in_specs, out_specs=out_specs,
                          check_vma=False)  # GPU demod kernel inside
        return jax.jit(f)

    # ------------------------------------------------------------------
    def step(self, body: jnp.ndarray, edges: jnp.ndarray,
             state: DemodState):
        """body: [C, block_len] raw samples; edges: [C, h_left+h_right]
        (the h_left raw samples before the block + h_right after).
        state: demod carry, pos relative to the block origin.

        Returns (outputs, new_state) where outputs mirrors the
        single-device ``step`` (symbols [C, S], each dense sync-distance
        stream [C, S] with the final sync_len-1 columns invalid, frame
        fields [C, S/frame_size, ...] where the protocol has them) and
        new_state.pos is already relative to the NEXT block origin.
        """
        out, st_cols = self._step(body, edges, state)
        new_state = jax.tree.map(lambda a: a[:, 0], st_cols)
        return out, new_state

    def drive(self, buffer, state, step_fn):
        """Run the block loop over every full buffered block — the ONE
        encoding of the halo/consume/recenter contract shared by both
        production drivers (TimeShardedStream and
        TimeShardedTrackedBank). ``step_fn(body, edges, state) ->
        (out, new_state)`` is the caller's device step plus any
        per-block host work. Returns ``(outs, state)``.

        Per-channel origins: the carried ``pos`` (>= 0) is where each
        channel's next symbol starts, relative to the body origin of the
        buffer (``h_left`` in) — the unsharded bank's own semantics. The
        timing of every channel wanders on its own: by clock skew (an
        SDR at ±20 ppm slews ~1 sample per 50 centuries) and, on an idle
        channel, by a random walk of ±1 per century on noise, so no
        common stride can hold all channels inside a fixed halo. Each
        step therefore cuts every channel's block at that channel's own
        ``pos`` and starts the device at ``pos == 0``; afterwards the
        buffer drops what the earliest channel no longer needs and the
        others keep their lead in ``pos``. Which samples a symbol reads
        is unchanged, so the stream stays byte-identical to the
        unsharded driver's variable per-symbol advance
        (fsk_demodulator.cpp:36-38)."""
        outs = []
        HL, B = self.h_left, self.block_len
        need = HL + B + self.h_right
        while True:
            lead = np.asarray(state.pos).astype(np.int64)
            if buffer.fill < need + int(lead.max()):
                return outs, state
            if lead.any():
                view = np.stack([buffer.data[c, k:k + need]
                                 for c, k in enumerate(lead)])
            else:
                view = buffer.view(need)
            body = jnp.asarray(view[:, HL:HL + B])
            edges = jnp.asarray(np.concatenate(
                [view[:, :HL], view[:, HL + B:]], axis=1))
            start = DemodState(jnp.zeros_like(state.pos), state.offset,
                               state.volume_ring)
            out, end = step_fn(body, edges, start)
            self.check_drift(end)
            outs.append(out)
            pos = lead + B + np.asarray(end.pos)
            base = int(pos.min())
            buffer.consume(base)
            state = DemodState(jnp.asarray(pos - base, jnp.int32),
                               end.offset, end.volume_ring)

    def check_drift(self, state) -> None:
        """A step's returned pos must stay inside the halo budget the
        sharded layout reserved (it can leave only a budget set below
        the default)."""
        pos = np.asarray(state.pos)
        if np.abs(pos).max() >= self.drift_budget:
            raise RuntimeError(
                f"timing drift {pos.min()}..{pos.max()} exceeded the "
                f"halo budget ±{self.drift_budget}; raise drift_budget "
                "or re-acquire")


class TimeShardedDmrPipeline(TimeShardedPipeline):
    """Backward-compatible DMR-specific entry point."""

    def __init__(self, mesh: Mesh, channels: int, sps: int = 10,
                 centuries_per_shard: int = 36, use_rrc: bool = True,
                 drift_budget: int | None = None):
        super().__init__(mesh, channels, protocol="dmr", sps=sps,
                         centuries_per_shard=centuries_per_shard,
                         use_rrc=use_rrc, drift_budget=drift_budget)


class TimeShardedStream:
    """Host driver for :class:`TimeShardedPipeline`.

    Mirrors ``StreamDriver``/bank feeding with the fixed-length step
    contract: keeps the raw left-edge tail, waits for ``h_right``
    lookahead samples, and cuts each channel's block at its own carried
    ``pos`` (:meth:`TimeShardedPipeline.drive`).
    """

    def __init__(self, pipeline: TimeShardedPipeline):
        from ..runtime.stream import SampleBuffer

        self.p = pipeline
        self.state = pipeline.init_state()
        self.buffer = SampleBuffer(pipeline.channels)
        # prime the left edge: stream start = zeros (reference delay
        # lines start zeroed)
        self.buffer.push(np.zeros((pipeline.channels, pipeline.h_left),
                                  np.float32))

    def push(self, samples: np.ndarray) -> list[dict]:
        self.buffer.push(samples)
        outs, self.state = self.p.drive(self.buffer, self.state,
                                        self.p.step)
        return outs


# backward-compatible alias (round-1/2 name)
TimeShardedDmrStream = TimeShardedStream
