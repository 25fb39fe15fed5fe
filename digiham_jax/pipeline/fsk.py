"""Fused device pipeline for 2FSK bit-stream protocols (D-Star, POCSAG).

samples -> (optional RRC) -> 2FSK demod -> bits + dense sync distances for
the protocol's patterns. ChannelBank-compatible step contract.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.demod import DemodState, demod_init, rrc_demod_block
from ..dsp.rrc import RrcDesign, RrcState
from ..fec.lfsr import dstar_scrambler
from ..protocols.dstar.phases import HEADER_SYNC, TERMINATOR, VOICE_SYNC
from ..protocols.pocsag import SYNC_PATTERN as POCSAG_SYNC
from ..protocols.pocsag import parse_codewords


def bit_sync_correlate(bits: jnp.ndarray, pattern: np.ndarray):
    """[C, T] bits -> [C, T-len+1] distances (one exact convolution,
    ops/correlate.py)."""
    from ..ops.correlate import sync_correlate_conv

    return sync_correlate_conv(bits, [np.asarray(pattern)], 2)[..., 0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FskPipelineState:
    rrc: RrcState | None
    demod: DemodState

    def tree_flatten(self):
        return (self.rrc, self.demod), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class FskPipeline:
    """2FSK front end for a channel bank.

    protocol: "dstar" (10 sps, no RRC, header+voice sync correlations) or
    "pocsag" (40 sps, inverted, preamble correlation).
    """

    def __init__(self, channels: int, protocol: str = "dstar",
                 n_centuries: int = 4, rrc: RrcDesign | None = None,
                 sps: int | None = None):
        self.channels = channels
        self.protocol = protocol
        if protocol == "dstar":
            self.sps, self.invert = 10, False
            self.patterns = {"header_sync": HEADER_SYNC,
                             "voice_sync": VOICE_SYNC}
        elif protocol == "pocsag":
            # default 40 sps = 1200 baud @48k; override for 512/2400
            # (the reference's --samples flag, fsk_demodulator_cli.hpp:16)
            self.sps, self.invert = 40, True
            self.patterns = {"preamble": POCSAG_SYNC}
        else:
            raise ValueError(protocol)
        if sps is not None:
            self.sps = sps
        self.rrc = rrc
        self.rrc_design = rrc  # uniform driver-facing attribute
        self.n_centuries = n_centuries
        self.symbols_per_block = n_centuries * 100

    def init_state(self) -> FskPipelineState:
        rrc_state = (RrcState.init(self.channels, self.rrc)
                     if self.rrc is not None else None)
        return FskPipelineState(rrc_state, demod_init(self.channels))

    @functools.partial(jax.jit, static_argnums=0,
                       static_argnames=("impl",))
    def step(self, samples: jnp.ndarray, state: FskPipelineState,
             impl: str | None = None):
        impl = impl or "auto"
        bits, rrc_state, demod_state = rrc_demod_block(
            samples, state.rrc, state.demod, self.n_centuries, self.sps,
            self.rrc, mode="fsk", invert=self.invert, impl=impl)
        outputs = {"dibits": bits}
        for name, pattern in self.patterns.items():
            outputs[f"sync_dist_{name}"] = bit_sync_correlate(bits, pattern)
        return outputs, FskPipelineState(rrc_state, demod_state)


@jax.jit
def dstar_decode_frames(frames: jnp.ndarray):
    """Batched D-Star voice-frame fields for the tracked bank.

    frames: [B, 120] on-air bits — a 96-bit voice frame (72 voice + 24
    slow-data, dstar_phase.cpp:73-90) plus a 24-bit lookahead into the
    next frame for the full-length terminator check
    (dstar_phase.cpp:94-101). Returns per frame: voice bytes (LSB-first
    packed), descrambled slow-data bytes, terminator distances (full 48
    and half 24), and the voice-sync distance of the data section.
    """
    b = frames.astype(jnp.int32) & 1
    w_lsb = jnp.asarray([1 << k for k in range(8)], jnp.int32)
    voice = jnp.sum(
        b[..., :72].reshape(b.shape[:-1] + (9, 8)) * w_lsb, axis=-1)
    scr = jnp.asarray(dstar_scrambler()[:24].astype(np.int32))
    desc = b[..., 72:96] ^ scr
    data = jnp.sum(
        desc.reshape(desc.shape[:-1] + (3, 8)) * w_lsb, axis=-1)
    term = jnp.asarray(TERMINATOR.astype(np.int32))
    vsync = jnp.asarray(VOICE_SYNC.astype(np.int32))
    return {
        "voice": voice.astype(jnp.uint8),
        "data": data.astype(jnp.uint8),
        "term_full": jnp.sum(b[..., 72:120] ^ term, axis=-1),
        "term_half": jnp.sum(b[..., 72:96] ^ term[24:], axis=-1),
        "vsync_dist": jnp.sum(b[..., 72:96] ^ vsync, axis=-1),
    }


@jax.jit
def pocsag_decode_frames(frames: jnp.ndarray):
    """Batched POCSAG codeword fields for the tracked bank.

    frames: [B, 32] bits. Every 32-bit window gets BOTH interpretations
    computed at once — the BCH(31,21)+parity codeword decode
    (codeword.cpp:9-31) and the sync-word distance (pocsag_phase.cpp:38)
    — and the host frame machine picks per its counter state.
    """
    b = frames.astype(jnp.uint32) & 1
    w_msb = jnp.asarray([1 << (31 - i) for i in range(32)], jnp.uint32)
    word = jnp.sum(b * w_msb, axis=-1, dtype=jnp.uint32)
    full, ok = parse_codewords(word)
    sync = jnp.asarray(POCSAG_SYNC.astype(np.int32))
    return {
        "word": full.astype(jnp.uint32),
        "ok": ok,
        "sync_dist": jnp.sum(frames.astype(jnp.int32) ^ sync, axis=-1),
    }
