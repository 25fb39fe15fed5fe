"""Batched device-side NXDN pipeline stages.

Dense sync correlation plus batched SACCH/FACCH1 decoding (descramble ->
de-interleave -> de-puncture -> blocked-start Viterbi -> CRC) over
``[channels, frames, ...]`` arrays (reference per-unit logic:
src/nxdn_decoder/sacch.cpp, facch1.cpp, scrambler.cpp).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fec import interleave
from ..fec.crc import crc6_nxdn, crc12_nxdn
from ..fec.lfsr import nxdn_scrambler
from ..fec.viterbi import viterbi_decode
from ..protocols.nxdn.phases import FRAME_SYNC, SYNC_SIZE


@jax.jit
def nxdn_sync_correlate(dibits: jnp.ndarray) -> jnp.ndarray:
    """[C, T] dibits -> [C, T-9] distances to the NXDN frame sync (one
    exact convolution, ops/correlate.py)."""
    from ..ops.correlate import sync_correlate_conv

    return sync_correlate_conv(dibits, [FRAME_SYNC], 4)[..., 0]


def _descramble(d: jnp.ndarray, offset: int) -> jnp.ndarray:
    ks = nxdn_scrambler()[offset:offset + d.shape[-1]].astype(np.int32)
    return d ^ (jnp.asarray(ks) << 1)


def _bits_from_dibits(d: jnp.ndarray) -> jnp.ndarray:
    out = jnp.stack([(d >> 1) & 1, d & 1], axis=-1)
    return out.reshape(d.shape[:-1] + (d.shape[-1] * 2,))


def _depunctured_viterbi(bits: jnp.ndarray, table) -> jnp.ndarray:
    idx, mask = table
    inflated = jnp.where(jnp.asarray(mask),
                         bits[..., jnp.asarray(idx)], 0)
    dib = (inflated[..., 0::2] << 1) | inflated[..., 1::2]
    decoded, _ = viterbi_decode(dib, num_states=16, blocked_steps=4)
    return decoded


import dataclasses
import functools

from ..dsp.demod import DemodState, demod_init, rrc_demod_block
from ..dsp.rrc import NARROW_RRC, RrcState


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class NxdnPipelineState:
    rrc: RrcState
    demod: DemodState

    def tree_flatten(self):
        return (self.rrc, self.demod), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class NxdnPipeline:
    """Fused device pipeline for NXDN48 channel banks: narrow RRC ->
    4FSK @20 sps -> dibits + dense sync distances. ChannelBank-compatible."""

    def __init__(self, channels: int, sps: int = 20, n_centuries: int = 4,
                 use_rrc: bool = True):
        self.channels = channels
        self.sps = sps
        self.n_centuries = n_centuries
        self.use_rrc = use_rrc  # False = input is already RRC-filtered
        # exposed as data so drivers never dispatch on the class name
        self.rrc_design = NARROW_RRC if use_rrc else None
        self.symbols_per_block = n_centuries * 100

    def init_state(self) -> NxdnPipelineState:
        return NxdnPipelineState(RrcState.init(self.channels, NARROW_RRC),
                                 demod_init(self.channels))

    @functools.partial(jax.jit, static_argnums=0,
                       static_argnames=("impl",))
    def step(self, samples: jnp.ndarray, state: NxdnPipelineState,
             impl: str | None = None):
        impl = impl or "auto"
        dibits, rrc_state, demod_state = rrc_demod_block(
            samples, state.rrc, state.demod, self.n_centuries, self.sps,
            NARROW_RRC if self.use_rrc else None, impl=impl)
        outputs = {"dibits": dibits,
                   "sync_dist_dense": nxdn_sync_correlate(dibits)}
        return outputs, NxdnPipelineState(rrc_state, demod_state)


@jax.jit
def decode_sacch_batch(sacch_dibits: jnp.ndarray):
    """[..., 30] descrambled-domain raw SACCH dibits (pre-descramble, in-
    frame offset 8) -> (structure_index, payload_bits [..., 18], ok)."""
    d = _descramble(sacch_dibits.astype(jnp.int32), 8)
    bits60 = _bits_from_dibits(d)
    dei = bits60[..., jnp.asarray(interleave.nxdn_sacch())]
    decoded = _depunctured_viterbi(dei, interleave.depuncture_mask_sacch())
    crc = crc6_nxdn(26).compute(decoded[..., :26])
    w6 = jnp.asarray([1 << (5 - i) for i in range(6)], jnp.int32)
    received = jnp.sum(decoded[..., 26:32] * w6, axis=-1)
    ok = crc == received
    structure = ((decoded[..., 0] << 1) | decoded[..., 1]) ^ 0b11
    return structure, decoded[..., 8:26], ok


@jax.jit
def nxdn_decode_frames(frames: jnp.ndarray):
    """[..., 192] frame dibits -> field dict for the tracked bank:
    sync distance, LICH byte/ok, SACCH unit, per-slot packed voice bytes
    and FACCH1 message type/ok (both slots decoded; the host steal-flag
    logic picks which to use)."""
    d = frames.astype(jnp.int32)
    sync_dist = jax.lax.population_count(
        d[..., :SYNC_SIZE] ^ jnp.asarray(FRAME_SYNC, jnp.int32)).sum(-1)

    # LICH (lich.cpp:5-30): descramble 8 dibits at offset 0, take high
    # bits, parity over the top 4
    lich_d = _descramble(d[..., 10:18], 0)
    lich_bits = (lich_d >> 1) & 1
    check = lich_bits[..., :4].sum(-1) & 1
    lich_ok = lich_bits[..., 7] == check
    w7 = jnp.asarray([1 << (6 - i) for i in range(7)], jnp.int32)
    lich_byte = jnp.sum(lich_bits[..., :7] * w7, axis=-1)

    sacch_structure, sacch_bits, sacch_ok = decode_sacch_batch(
        d[..., 18:48])

    voice = []
    facch_mtype = []
    facch_ok = []
    for i in range(2):
        slot = _descramble(d[..., 48 + 72 * i:120 + 72 * i], 38 + 72 * i)
        quads = slot.reshape(slot.shape[:-1] + (18, 4))
        by = ((quads[..., 0] << 6) | (quads[..., 1] << 4)
              | (quads[..., 2] << 2) | quads[..., 3])
        voice.append(by.astype(jnp.uint8))
        mt, ok = decode_facch1_batch(
            d[..., 48 + 72 * i:120 + 72 * i], offset=38 + 72 * i)
        facch_mtype.append(mt)
        facch_ok.append(ok)

    return {
        "sync_dist": sync_dist,
        "lich_ok": lich_ok,
        "lich_byte": lich_byte,
        "sacch_structure": sacch_structure,
        "sacch_bits": sacch_bits,
        "sacch_ok": sacch_ok,
        "voice0": voice[0], "voice1": voice[1],
        "facch_mtype0": facch_mtype[0], "facch_ok0": facch_ok[0],
        "facch_mtype1": facch_mtype[1], "facch_ok1": facch_ok[1],
    }


@functools.partial(jax.jit, static_argnames=("offset",))
def decode_facch1_batch(slot_dibits: jnp.ndarray, offset: int = 38):
    """[..., 72] raw slot dibits -> (message_type, ok)."""
    d = _descramble(slot_dibits.astype(jnp.int32), offset)
    bits144 = _bits_from_dibits(d)
    dei = bits144[..., jnp.asarray(interleave.nxdn_facch1())]
    decoded = _depunctured_viterbi(dei, interleave.depuncture_mask_facch1())
    crc = crc12_nxdn(80).compute(decoded[..., :80])
    w12 = jnp.asarray([1 << (11 - i) for i in range(12)], jnp.int32)
    received = jnp.sum(decoded[..., 80:92] * w12, axis=-1)
    ok = crc == received
    w6 = jnp.asarray([1 << (5 - i) for i in range(6)], jnp.int32)
    mtype = jnp.sum(decoded[..., 2:8] * w6, axis=-1)
    return mtype, ok
