"""Batched device-side DMR pipeline: the flagship many-channel path.

The host phase machine (digiham_jax.protocols.dmr) is the acquisition /
metadata control plane. This module is the steady-state *tracking* path:
once a channel is frame-locked, every hot step runs as one fused XLA
program over ``[channels, ...]`` arrays:

    samples [C, L] -> RRC FIR -> GFSK demod -> frame slice [C, F, 144]
    -> {CACH/TACT Hamming(7,4), sync classify, SlotType Golay(20,8),
        BPTC(196,96), EMB QR(16,7), voice payload pack} all batched.

The outputs are dense per-frame field tensors; the host consumes them with
O(frames) numpy logic (hysteresis counters, LC dispatch) — no per-symbol
host work. Reference semantics per field are cited in the respective
kernels; the end-to-end behavioral contract is tested against the host
phase machine in tests/test_pipeline.py.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fec import bptc
from ..fec.codes import GOLAY_20_8, HAMMING_7_4, QR_16_7
from ..fec.linear import decode as fec_decode
from ..dsp.demod import DemodState, demod_init, rrc_demod_block
from ..dsp.rrc import WIDE_RRC, RrcState
from ..protocols.dmr.components import TACT_POSITIONS
from ..protocols.dmr.phases import (
    BS_DATA_SYNC,
    BS_VOICE_SYNC,
    CACH_SIZE,
    FRAME_SIZE,
    MS_DATA_SYNC,
    MS_VOICE_SYNC,
    SYNC_OFFSET,
    SYNC_SIZE,
)

_SYNC_PATTERNS = np.stack(
    [BS_DATA_SYNC, BS_VOICE_SYNC, MS_DATA_SYNC, MS_VOICE_SYNC])
# sync type per pattern row: data=1, voice=2 (dmr_phase.cpp:18-33)
_SYNC_TYPES = np.array([1, 2, 1, 2], dtype=np.int32)


@jax.jit
def dmr_sync_correlate(dibits: jnp.ndarray) -> jnp.ndarray:
    """Dense sync correlation: [C, T] dibits -> [C, T-23, 4] distances.

    Replaces the reference's symbol-at-a-time scan (dmr_phase.cpp:39-47)
    with one batched correlation over every offset and all 4 patterns as
    a single exact convolution (ops/correlate.py).
    """
    from ..ops.correlate import sync_correlate_conv

    return sync_correlate_conv(dibits, _SYNC_PATTERNS, 4)


def _pack_dibits_27(dibits108: jnp.ndarray) -> jnp.ndarray:
    """[..., 108] dibits -> [..., 27] bytes MSB-first (dmr_phase.cpp:216)."""
    q = dibits108.astype(jnp.int32).reshape(dibits108.shape[:-1] + (27, 4))
    return ((q[..., 0] << 6) | (q[..., 1] << 4) | (q[..., 2] << 2)
            | q[..., 3]).astype(jnp.uint8)


@jax.jit
def dmr_decode_frames(frames: jnp.ndarray):
    """Decode a batch of aligned frames: [..., 144] dibits -> field dict.

    All FEC is batched syndrome decoding on device. Returns a dict of
    arrays with leading shape [...]:
      tact_ok, tact_slot, tact_busy, tact_lcss   — CACH/TACT
      sync_dist [4], sync_type                   — mid-frame sync classify
      emb_ok, emb_lcss, emb_cc, emb_fragment[4]  — voice superframe EMB
      voice_payload [27] uint8                   — packed voice bytes
      slot_type_ok, color_code, data_type        — SlotType golay
      bptc_data [96], bptc_ok                    — data-frame BPTC bits
    """
    d = frames.astype(jnp.int32)
    batch = d.shape[:-1]

    # --- CACH / TACT (cach.cpp:11-32, tact.cpp:9-12) -------------------
    cach_dibits = d[..., :CACH_SIZE]
    bits24 = jnp.stack(
        [(cach_dibits >> 1) & 1, cach_dibits & 1], axis=-1
    ).reshape(batch + (24,))
    tact_bits = bits24[..., jnp.asarray(TACT_POSITIONS)]
    weights7 = jnp.asarray([1 << (6 - i) for i in range(7)], jnp.int32)
    tact_word = jnp.sum(tact_bits * weights7, axis=-1)
    tact_corr, tact_ok = fec_decode(HAMMING_7_4, tact_word)
    tact_slot = (tact_corr >> 5) & 1
    tact_busy = (tact_corr >> 6) & 1
    tact_lcss = (tact_corr >> 3) & 3

    # --- sync classification (dmr_phase.cpp:18-33) ----------------------
    sync = d[..., SYNC_OFFSET:SYNC_OFFSET + SYNC_SIZE]
    pats = jnp.asarray(_SYNC_PATTERNS, jnp.int32)
    sync_dist = jax.lax.population_count(
        sync[..., None, :] ^ pats).sum(axis=-1)  # [..., 4]
    match = sync_dist <= 3
    first = jnp.argmax(match, axis=-1)
    any_match = jnp.any(match, axis=-1)
    sync_type = jnp.where(
        any_match, jnp.asarray(_SYNC_TYPES)[first], -1)

    # --- EMB + embedded fragment (dmr_phase.cpp:117-155) ----------------
    emb_dibits = jnp.concatenate(
        [d[..., SYNC_OFFSET:SYNC_OFFSET + 4],
         d[..., SYNC_OFFSET + 20:SYNC_OFFSET + 24]], axis=-1)
    # dibit i occupies bits (15-2i, 14-2i) of the 16-bit EMB word
    emb_word = jnp.zeros(batch, jnp.int32)
    for i in range(8):
        emb_word = (emb_word << 2) | emb_dibits[..., i]
    emb_corr, emb_ok = fec_decode(QR_16_7, emb_word)
    emb_cc = (emb_corr >> 12) & 0b1111
    emb_lcss = (emb_corr >> 9) & 0b11
    frag_dibits = d[..., SYNC_OFFSET + 4:SYNC_OFFSET + 20]  # [..., 16]
    fq = frag_dibits.reshape(batch + (4, 4))
    emb_fragment = ((fq[..., 0] << 6) | (fq[..., 1] << 4)
                    | (fq[..., 2] << 2) | fq[..., 3]).astype(jnp.uint8)

    # --- voice payload (dmr_phase.cpp:210-227) --------------------------
    voice_dibits = jnp.concatenate(
        [d[..., CACH_SIZE:CACH_SIZE + 54],
         d[..., CACH_SIZE + 54 + SYNC_SIZE:]], axis=-1)
    voice_payload = _pack_dibits_27(voice_dibits)

    # --- SlotType (dmr_phase.cpp:235-252) -------------------------------
    st_dibits = jnp.concatenate(
        [d[..., SYNC_OFFSET - 5:SYNC_OFFSET],
         d[..., SYNC_OFFSET + SYNC_SIZE:SYNC_OFFSET + SYNC_SIZE + 5]],
        axis=-1)
    st_word = jnp.zeros(batch, jnp.int32)
    for i in range(10):
        st_word = (st_word << 2) | st_dibits[..., i]
    st_corr, st_ok = fec_decode(GOLAY_20_8, st_word)
    color_code = (st_corr >> 16) & 0b1111
    data_type = (st_corr >> 12) & 0b1111

    # --- BPTC(196,96) (dmr_phase.cpp:253-270) ---------------------------
    bptc_dibits = jnp.concatenate(
        [d[..., CACH_SIZE:CACH_SIZE + 49],
         d[..., CACH_SIZE + 54 + SYNC_SIZE + 5:
            CACH_SIZE + 54 + SYNC_SIZE + 5 + 49]], axis=-1)
    bits196 = jnp.stack(
        [(bptc_dibits >> 1) & 1, bptc_dibits & 1], axis=-1
    ).reshape(batch + (196,))
    bptc_data, bptc_ok = bptc.decode(bits196)

    return {
        "tact_ok": tact_ok, "tact_slot": tact_slot,
        "tact_busy": tact_busy, "tact_lcss": tact_lcss,
        "sync_dist": sync_dist, "sync_type": sync_type,
        "emb_ok": emb_ok, "emb_cc": emb_cc, "emb_lcss": emb_lcss,
        "emb_fragment": emb_fragment,
        "voice_payload": voice_payload,
        "slot_type_ok": st_ok, "color_code": color_code,
        "data_type": data_type,
        "bptc_data": bptc_data, "bptc_ok": bptc_ok,
    }


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DmrPipelineState:
    rrc: RrcState
    demod: DemodState

    def tree_flatten(self):
        return (self.rrc, self.demod), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class DmrPipeline:
    """Fused device pipeline: FM-demodulated samples -> decoded DMR frame
    fields for a bank of channels.

    One ``step`` consumes ``n_centuries*100`` symbols worth of samples per
    channel and emits every frame-aligned decode the block contains. Frame
    alignment is chosen per channel on the host from the dense sync
    correlation (acquisition); the steady-state math is all device-side.
    """

    def __init__(self, channels: int, sps: int = 10, n_centuries: int = 8,
                 use_rrc: bool = True):
        self.channels = channels
        self.sps = sps
        self.n_centuries = n_centuries
        self.use_rrc = use_rrc  # False = input is already RRC-filtered
        # the filter design this pipeline applies, exposed as data so
        # drivers (runtime/tracked_bank._flush_demod) never dispatch on
        # the class name — subclasses inherit or override the attribute
        self.rrc_design = WIDE_RRC if use_rrc else None
        self.symbols_per_block = n_centuries * 100

    def init_state(self) -> DmrPipelineState:
        return DmrPipelineState(
            rrc=RrcState.init(self.channels, WIDE_RRC),
            demod=demod_init(self.channels),
        )

    @functools.partial(jax.jit, static_argnums=0,
                       static_argnames=("impl",))
    def step_iq(self, iq: jnp.ndarray, last_iq: jnp.ndarray,
                state: DmrPipelineState, impl: str | None = None):
        """Raw-IQ ingest variant: [C, L] complex64 -> FM discriminator ->
        the sample pipeline (the on-device equivalent of the reference's
        external rtl_fm front end). last_iq: [C] carry.
        Returns (outputs, new_iq_carry, new state)."""
        from ..dsp.fm import fm_discriminator

        audio, iq_carry = fm_discriminator(iq, last_iq)
        out, new_state = self.step(audio * 5000.0, state, impl=impl)
        return out, iq_carry, new_state

    @functools.partial(jax.jit, static_argnums=0,
                       static_argnames=("impl",))
    def step_iq_planes(self, re: jnp.ndarray, im: jnp.ndarray,
                       last_re: jnp.ndarray, last_im: jnp.ndarray,
                       state: DmrPipelineState, impl: str | None = None):
        """Planar raw-IQ ingest: [C, L] float32 I and Q planes, for
        callers whose samples arrive as separate planes. Same chain as
        :meth:`step_iq`.
        Returns (outputs, (new_last_re, new_last_im), new state)."""
        from ..dsp.fm import fm_discriminator

        audio, _ = fm_discriminator(jax.lax.complex(re, im),
                                    jax.lax.complex(last_re, last_im))
        out, new_state = self.step(audio * 5000.0, state, impl=impl)
        return out, (re[:, -1], im[:, -1]), new_state

    @functools.partial(jax.jit, static_argnums=0,
                       static_argnames=("impl",))
    def step(self, samples: jnp.ndarray, state: DmrPipelineState,
             impl: str | None = None):
        """samples: [C, L] float32 (L >= pos_max + n_centuries*(100*sps+1)).

        Returns (outputs dict, new state): dibits [C, S], sync distances
        [C, S-23, 4], and frame fields decoded at every 144-aligned offset
        ([C, S//144, ...]).

        impl: None (default "auto") or "xla" —
        "xla" forces the plain demod scan; pass it per call when stepping
        under GSPMD auto-partitioning (mesh banks), which cannot split the
        GPU demod kernel's custom call. Being a static argument, each
        impl gets its own jit trace — no attribute-mutation hazards.
        """
        impl = impl or "auto"
        dibits, rrc_state, demod_state = rrc_demod_block(
            samples, state.rrc, state.demod, self.n_centuries, self.sps,
            WIDE_RRC if self.use_rrc else None, impl=impl)
        return self._post(dibits), DmrPipelineState(rrc_state,
                                                    demod_state)

    def _post(self, dibits):
        """Symbol-domain tail shared by every ingest variant: dense sync
        correlation + batched per-frame field decode."""
        sync_dist_dense = dmr_sync_correlate(dibits)
        n_frames = self.symbols_per_block // FRAME_SIZE
        frames = dibits[:, :n_frames * FRAME_SIZE].reshape(
            self.channels, n_frames, FRAME_SIZE)
        fields = dmr_decode_frames(frames)
        return {"dibits": dibits, "sync_dist_dense": sync_dist_dense,
                **fields}
