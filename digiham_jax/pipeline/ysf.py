"""Batched device-side YSF pipeline stages.

Steady-state tracking path for YSF channel banks: dense sync correlation,
batched FICH decode (de-interleave -> Viterbi -> 4x Golay(24,12) -> CRC)
and batched V/D2 voice extraction (de-interleave -> dewhiten -> tribit
majority -> AMBE bit mapping) over ``[channels, frames, ...]`` arrays.
Host phase machines consume the resulting field tensors.

Reference behavior per stage: src/ysf_decoder/fich.cpp,
ysf_phase.cpp:180-219 (voice), 100-108 + 258-267 (DCH).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fec import interleave
from ..fec.codes import GOLAY_24_12
from ..fec.crc import crc16_ysf
from ..fec.lfsr import ysf_whitening
from ..fec.linear import decode as fec_decode
from ..fec.viterbi import viterbi_decode
from ..protocols.ysf.phases import (
    FICH_SIZE,
    FRAME_SIZE,
    SYNC_SIZE,
    TRIBIT_MAJORITY,
    V2_VOICE_MAPPING,
    YSF_SYNC,
)


@jax.jit
def ysf_sync_correlate(dibits: jnp.ndarray) -> jnp.ndarray:
    """[C, T] dibits -> [C, T-19] distances to the YSF sync word (one
    exact convolution, ops/correlate.py)."""
    from ..ops.correlate import sync_correlate_conv

    return sync_correlate_conv(dibits, [YSF_SYNC], 4)[..., 0]


def _bits_from_dibits(d: jnp.ndarray) -> jnp.ndarray:
    out = jnp.stack([(d >> 1) & 1, d & 1], axis=-1)
    return out.reshape(d.shape[:-1] + (d.shape[-1] * 2,))


@jax.jit
def decode_fich_batch(fich_dibits: jnp.ndarray):
    """[..., 100] FICH dibits -> (fich_word [...] uint32, ok [...] bool).

    Batched over any leading shape (channels x frames).
    """
    d = fich_dibits.astype(jnp.int32)
    x = d[..., jnp.asarray(interleave.ysf_fich())]
    bits, _metric = viterbi_decode(x)  # [..., 100]
    # pack 96 bits -> 4x24-bit golay words
    b96 = bits[..., :96].reshape(bits.shape[:-1] + (4, 24))
    w24 = jnp.asarray([1 << (23 - i) for i in range(24)], jnp.int32)
    words = jnp.sum(b96 * w24, axis=-1)  # [..., 4]
    corrected, ok4 = fec_decode(GOLAY_24_12, words)
    ok = jnp.all(ok4, axis=-1)
    g = corrected
    fich_data = (
        ((g[..., 0] & 0x00FFF000) << 8)
        | ((g[..., 1] & 0x00FFF000) >> 4)
        | ((g[..., 2] & 0x00FF0000) >> 16)
    )
    checksum = (g[..., 2] & 0x0000F000) | ((g[..., 3] & 0x00FFF000) >> 12)
    # CRC over the big-endian byte order of fich_data
    be_bits = jnp.stack(
        [(fich_data >> (31 - i)) & 1 for i in range(32)], axis=-1)
    crc = crc16_ysf(32).compute(be_bits)
    ok = ok & (crc == checksum)
    return fich_data.astype(jnp.uint32), ok


@jax.jit
def decode_vd2_voice_batch(voice_dibits: jnp.ndarray) -> jnp.ndarray:
    """[..., 52] V/D2 voice dibits -> [..., 7] packed AMBE bytes."""
    bits104 = _bits_from_dibits(voice_dibits.astype(jnp.int32))
    dei = bits104[..., jnp.asarray(interleave.ysf_v2_voice())]
    tri = dei ^ jnp.asarray(ysf_whitening()[:104].astype(np.int32))
    groups = tri[..., :81].reshape(tri.shape[:-1] + (27, 3))
    idx = (groups[..., 0] << 2) | (groups[..., 1] << 1) | groups[..., 2]
    voice27 = jnp.asarray(TRIBIT_MAJORITY.astype(np.int32))[idx]
    voice49 = jnp.concatenate([voice27, tri[..., 81:103]], axis=-1)
    # scatter voice bit i to output bit V2_VOICE_MAPPING[i]
    result = jnp.zeros(voice49.shape[:-1] + (56,), jnp.int32)
    result = result.at[..., jnp.asarray(V2_VOICE_MAPPING)].set(voice49)
    w8 = jnp.asarray([1 << (7 - i) for i in range(8)], jnp.int32)
    by = jnp.sum(result.reshape(result.shape[:-1] + (7, 8)) * w8, axis=-1)
    return by.astype(jnp.uint8)


import dataclasses

from ..dsp.demod import DemodState, demod_init, rrc_demod_block
from ..dsp.rrc import WIDE_RRC, RrcState


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class YsfPipelineState:
    rrc: RrcState
    demod: DemodState

    def tree_flatten(self):
        return (self.rrc, self.demod), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class YsfPipeline:
    """Fused device pipeline for YSF channel banks: samples -> dibits ->
    dense sync distances + per-480-frame FICH/voice fields. ChannelBank-
    compatible (same step contract as DmrPipeline)."""

    def __init__(self, channels: int, sps: int = 10, n_centuries: int = 10,
                 use_rrc: bool = True):
        self.channels = channels
        self.sps = sps
        self.n_centuries = n_centuries
        self.use_rrc = use_rrc  # False = input is already RRC-filtered
        # exposed as data so drivers never dispatch on the class name
        self.rrc_design = WIDE_RRC if use_rrc else None
        self.symbols_per_block = n_centuries * 100

    def init_state(self) -> YsfPipelineState:
        return YsfPipelineState(RrcState.init(self.channels, WIDE_RRC),
                                demod_init(self.channels))

    @functools.partial(jax.jit, static_argnums=0,
                       static_argnames=("impl",))
    def step(self, samples: jnp.ndarray, state: YsfPipelineState,
             impl: str | None = None):
        impl = impl or "auto"
        dibits, rrc_state, demod_state = rrc_demod_block(
            samples, state.rrc, state.demod, self.n_centuries, self.sps,
            WIDE_RRC if self.use_rrc else None, impl=impl)
        sync_dist_dense = ysf_sync_correlate(dibits)
        n_frames = self.symbols_per_block // FRAME_SIZE
        fields = {}
        if n_frames:
            frames = dibits[:, :n_frames * FRAME_SIZE].reshape(
                self.channels, n_frames, FRAME_SIZE)
            fields = ysf_decode_frames(frames)
        outputs = {"dibits": dibits, "sync_dist_dense": sync_dist_dense,
                   **fields}
        return outputs, YsfPipelineState(rrc_state, demod_state)


@jax.jit
def decode_vd2_dch_batch(payload: jnp.ndarray):
    """[..., 360] payload dibits -> (dch bytes [..., 10] uint8, ok).

    Batched V/D2 data channel (ysf_phase.cpp:100-108 + 258-267):
    de-interleave, Viterbi, CRC over the whitened bits, dewhiten.
    """
    d = payload.astype(jnp.int32)
    dch_dibits = d[..., jnp.asarray(interleave.ysf_dch_v2())]
    bits, _ = viterbi_decode(dch_dibits)  # [..., 100]
    w8 = jnp.asarray([1 << (7 - i) for i in range(8)], jnp.int32)
    by = jnp.sum(bits[..., :96].reshape(bits.shape[:-1] + (12, 8)) * w8,
                 axis=-1)
    checksum = (by[..., 10] << 8) | by[..., 11]
    crc = crc16_ysf(80).compute(bits[..., :80])
    ok = crc == checksum
    clear = bits ^ jnp.asarray(ysf_whitening()[:100].astype(np.int32))
    dch = jnp.sum(clear[..., :80].reshape(clear.shape[:-1] + (10, 8)) * w8,
                  axis=-1)
    return dch.astype(jnp.uint8), ok


@jax.jit
def ysf_decode_frames(frames: jnp.ndarray):
    """[..., 480] frame dibits -> field dict: sync distance, FICH word/ok,
    V/D2 voice bytes for all 5 blocks, V/D2 DCH bytes/ok."""
    d = frames.astype(jnp.int32)
    sync = d[..., :SYNC_SIZE]
    sync_dist = jax.lax.population_count(
        sync ^ jnp.asarray(YSF_SYNC, jnp.int32)).sum(-1)
    fich_data, fich_ok = decode_fich_batch(
        d[..., SYNC_SIZE:SYNC_SIZE + FICH_SIZE])
    payload = d[..., SYNC_SIZE + FICH_SIZE:FRAME_SIZE]
    blocks = jnp.stack(
        [payload[..., 20 + i * 72:20 + i * 72 + 52] for i in range(5)],
        axis=-2)  # [..., 5, 52]
    voice = decode_vd2_voice_batch(blocks)
    dch, dch_ok = decode_vd2_dch_batch(payload)
    return {
        "sync_dist": sync_dist,
        "fich_data": fich_data,
        "fich_ok": fich_ok,
        "vd2_voice": voice,
        "vd2_dch": dch,
        "vd2_dch_ok": dch_ok,
    }
