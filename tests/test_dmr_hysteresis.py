"""DMR slot-tracking and sync-hysteresis property tests — the counters
and caps define when output appears at low SNR (SURVEY.md §5 /
dmr_phase.cpp:65-205), so they get targeted adversarial coverage."""
import numpy as np
import pytest

from digiham_jax.protocols.dmr import make_decoder
from digiham_jax.protocols.dmr.phases import (
    FRAME_SIZE,
    FramePhase,
    SyncPhase,
    pack_dibits,
)
from digiham_jax.runtime.meta import PipelineMetaWriter

from dmr_synth import make_cach, voice_frame


def corrupt_cach(frame, rng):
    """Destroy the TACT so has_tact() fails."""
    f = frame.copy()
    f[:12] = rng.integers(0, 4, 12)
    return f


def wrong_slot_frame(frame, slot):
    f = frame.copy()
    f[:12] = make_cach(slot)
    return f


class TestSlotTracking:
    def test_wrong_tact_overridden_when_stability_high(self):
        """After many consistent frames, slotStability >= 5: a single
        contradicting TACT must NOT flip the slot (dmr_phase.cpp:75-92)."""
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(12)]
        # frame 8 claims the wrong slot
        frames[8] = wrong_slot_frame(frames[8], (8 % 2) ^ 1)
        out = make_decoder().process(
            np.concatenate(frames + [np.zeros(150, np.uint8)]))
        # stream survives: nearly all slot-0 frames decoded
        assert len(out) // 27 >= 4

    def test_low_stability_follows_tact(self):
        """Early on (stability < 5) a contradicting TACT resets tracking
        to the TACT's slot (dmr_phase.cpp:77-84)."""
        payload = np.tile([1, 3, 0, 2], 27)
        # all frames claim slot 0: tact never matches the alternation
        # assumption after the first, driving the stability branch
        frames = [voice_frame(0, payload, sync=True) for _ in range(8)]
        dec = make_decoder()
        out = dec.process(np.concatenate(frames))
        # decoder still emits voice (slot arbitration settles on 0)
        assert len(out) >= 27

    def test_missing_tact_keeps_alternating(self):
        """Frames with corrupt CACH still decode while sync holds
        (slot = next, stability decremented; dmr_phase.cpp:94-99)."""
        rng = np.random.default_rng(0)
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(10)]
        for i in (4, 5, 6):
            frames[i] = corrupt_cach(frames[i], rng)
        out = make_decoder().process(np.concatenate(frames))
        assert len(out) // 27 >= 6  # corrupted-CACH frames still decode


class TestSyncCounters:
    def _run_phase_counts(self, frames):
        dec = make_decoder()
        dec.process(np.concatenate(frames))
        return dec

    def test_five_cap_and_dropout(self):
        """syncCount caps at 5; after sync loss the phase survives
        exactly as many frames as the counter allows before re-hunting
        (dmr_phase.cpp:104-106, 188-205)."""
        payload = np.tile([1, 3, 0, 2], 27)
        good = [voice_frame(s % 2, payload, sync=True) for s in range(10)]
        rng = np.random.default_rng(1)
        bad = [rng.integers(0, 4, FRAME_SIZE).astype(np.uint8)
               for _ in range(14)]
        dec = make_decoder()
        dec.process(np.concatenate(good + bad + [np.zeros(200, np.uint8)]))
        # decoder must have returned to sync hunting
        assert isinstance(dec.current_phase, SyncPhase)

    def test_recovers_quickly_after_reacquisition(self):
        payload = np.tile([1, 3, 0, 2], 27)
        good = [voice_frame(s % 2, payload, sync=True) for s in range(8)]
        rng = np.random.default_rng(2)
        bad = [rng.integers(0, 4, FRAME_SIZE).astype(np.uint8)
               for _ in range(14)]
        stream = np.concatenate(good + bad + good
                                + [np.zeros(200, np.uint8)])
        out = make_decoder().process(stream)
        # both good segments decode
        assert len(out) // 27 >= 6

    def test_voice_to_data_soft_reset(self):
        """voice -> data sync transition soft-resets call metadata but
        keeps sync (dmr_phase.cpp:108-114)."""
        from dmr_synth import data_frame, group_lc
        from digiham_jax.protocols.dmr.components import DATA_TYPE_IDLE
        payload = np.tile([1, 3, 0, 2], 27)
        lc = group_lc(100, 200)
        frames = ([data_frame(s % 2, 1, lc) for s in range(4)]
                  + [voice_frame(s % 2, payload, sync=True)
                     for s in range(4)]
                  + [data_frame(s % 2, DATA_TYPE_IDLE, lc)
                     for s in range(2)])
        dec = make_decoder()
        events = []
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b: events.append(b.decode())))
        dec.process(np.concatenate(frames + [np.zeros(150, np.uint8)]))
        # a voice->data transition produced a soft-reset event (sync kept,
        # call fields dropped)
        assert any(e.startswith("protocol:DMR")
                   and "sync:data" in e and "source:" not in e
                   for e in events[2:])
        assert isinstance(dec.current_phase, FramePhase)
