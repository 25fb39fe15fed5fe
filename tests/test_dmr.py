"""DMR decoder tests: synthesized TDMA bursts -> voice payload + metadata."""
import numpy as np
import pytest

from digiham_jax.protocols.dmr import make_decoder
from digiham_jax.protocols.dmr.components import (
    DATA_TYPE_IDLE,
    DATA_TYPE_TERMINATOR_LC,
    DATA_TYPE_VOICE_LC,
    EmbeddedCollector,
    LC_GPS_INFO,
    TalkerAliasCollector,
)
from digiham_jax.protocols.dmr.phases import pack_dibits
from digiham_jax.runtime.meta import PipelineMetaWriter

from dmr_synth import (
    data_frame,
    group_lc,
    embedded_fragments,
    interleave_slots,
    make_lc_bytes,
    voice_frame,
    voice_superframe,
)


def attach_meta(dec):
    events = []
    dec.set_meta_writer(PipelineMetaWriter(lambda b: events.append(b.decode())))
    return events


def lead_in(slot=0):
    """A couple of data frames so sync + slot tracking lock before the
    payload under test."""
    lc = group_lc(0, 0)
    return [data_frame(s % 2, DATA_TYPE_IDLE, lc) for s in range(slot, slot + 4)]


class TestSyncAcquisition:
    def test_acquires_after_noise(self):
        rng = np.random.default_rng(0)
        noise = rng.integers(0, 4, 500).astype(np.uint8)
        payload = (np.arange(108) * 3) % 4
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(6)]
        stream = np.concatenate([noise] + frames)
        dec = make_decoder()
        out = dec.process(stream)
        # voice frames after lock produce 27-byte payloads
        assert len(out) % 27 == 0
        assert len(out) >= 27
        assert out[:27] == pack_dibits(payload)

    def test_no_sync_no_output(self):
        rng = np.random.default_rng(1)
        noise = rng.integers(0, 4, 3000).astype(np.uint8)
        assert make_decoder().process(noise) == b""


class TestVoicePayload:
    def test_single_slot_stream(self):
        """TDMA: alternating-slot voice bursts; active-slot arbitration
        locks onto the first slot, so only its frames are emitted."""
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(8)]
        out = make_decoder().process(np.concatenate(frames))
        n = len(out) // 27
        assert n >= 3  # one slot's worth (every other frame)
        for i in range(n):
            assert out[27 * i:27 * (i + 1)] == pack_dibits(payload)

    def test_slot_filter_mutes(self):
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(8)]
        dec = make_decoder()
        dec.set_slot_filter(0)  # mute both slots
        out = dec.process(np.concatenate(frames))
        assert out == b""

    def test_active_slot_arbitration(self):
        """Both slots voice: only the first active one is emitted."""
        pay0 = np.tile([1, 3, 0, 2], 27)
        pay1 = np.tile([2, 0, 3, 1], 27)
        s0 = [voice_frame(0, pay0, sync=True) for _ in range(5)]
        s1 = [voice_frame(1, pay1, sync=True) for _ in range(5)]
        out = make_decoder().process(interleave_slots(s0, s1))
        chunks = [out[i:i + 27] for i in range(0, len(out), 27)]
        assert len(chunks) >= 4
        assert all(c == pack_dibits(pay0) for c in chunks)


class TestDataFrames:
    def test_voice_lc_metadata(self):
        lc = group_lc(2300042, 2623317)
        frames = [data_frame(s % 2, DATA_TYPE_VOICE_LC, lc) for s in range(6)]
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(np.concatenate(frames))
        assert any("source:2623317" in e and "target:2300042" in e
                   and "type:group" in e for e in events)
        assert any("protocol:DMR" in e for e in events)

    def test_unit_to_unit_type(self):
        lc = group_lc(100, 200, opcode=3)
        frames = [data_frame(s % 2, DATA_TYPE_VOICE_LC, lc) for s in range(6)]
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(np.concatenate(frames))
        assert any("type:direct" in e for e in events)

    def test_terminator_soft_resets(self):
        lc = group_lc(42, 43)
        frames = [data_frame(s % 2, DATA_TYPE_VOICE_LC, lc) for s in range(4)]
        frames += [data_frame(s % 2, DATA_TYPE_TERMINATOR_LC, lc)
                   for s in range(2)]
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(np.concatenate(frames))
        # after terminator, a metadata event without source appears
        later = events[-1]
        assert "source:" not in later

    def test_gps_lc(self):
        # latitude 0x200000 * 180/2^24 = 22.5, longitude 0x400000*360/2^25=45
        payload = bytes([0, 0x40, 0, 0, 0x20, 0, 0])
        lc = make_lc_bytes(LC_GPS_INFO, payload)
        frames = [data_frame(s % 2, DATA_TYPE_VOICE_LC, lc) for s in range(6)]
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(np.concatenate(frames))
        assert any("lat:22.5" in e and "lon:45.0" in e for e in events)


class TestEmbeddedLc:
    def test_fragments_roundtrip(self):
        lc = group_lc(1234567, 7654321)
        frags = embedded_fragments(lc)
        coll = EmbeddedCollector()
        for f in frags:
            coll.collect(f)
        got = coll.get_lc()
        assert got is not None
        assert got.data == lc

    def test_corrupted_fragment_rejected(self):
        lc = group_lc(111, 222)
        frags = [bytearray(f) for f in embedded_fragments(lc)]
        frags[1][2] ^= 0xFF  # heavy damage
        coll = EmbeddedCollector()
        for f in frags:
            coll.collect(bytes(f))
        # either rejected or not equal to the original — never silently ok
        got = coll.get_lc()
        assert got is None or got.data != lc

    def test_superframe_delivers_lc_metadata(self):
        lc = group_lc(3100999, 3100001)
        payload = np.tile([1, 3, 0, 2], 27)
        frames = voice_superframe(0, lc, payload)
        # two superframes for sync stability
        stream = np.concatenate(frames + frames)
        dec = make_decoder()
        events = attach_meta(dec)
        out = dec.process(stream)
        assert len(out) >= 27
        assert any("source:3100001" in e and "target:3100999" in e
                   for e in events)


class TestTalkerAlias:
    def test_8bit_alias(self):
        coll = TalkerAliasCollector()
        # header: format 8BIT (1<<6), length 6 chars (<<1)
        coll.set_block(0, bytes([(1 << 6) | (6 << 1)]) + b"CALL-1")
        assert coll.is_complete()
        assert coll.get_contents() == "CALL-1"

    def test_utf16_alias(self):
        coll = TalkerAliasCollector()
        text = "DL1ABC"
        enc = text.encode("utf-16-be")
        coll.set_block(0, bytes([(3 << 6) | (len(text) << 1)]) + enc[:6])
        coll.set_block(1, enc[6:12] + b"\x00")
        assert coll.is_complete()
        assert coll.get_contents() == text

    def test_incomplete_without_header(self):
        coll = TalkerAliasCollector()
        coll.set_block(1, b"ABCDEFG")
        assert not coll.is_complete()
        assert coll.get_contents() == ""


class TestResilience:
    def test_sync_dropout_recovery(self):
        payload = np.tile([1, 3, 0, 2], 27)
        good = [voice_frame(s % 2, payload, sync=True) for s in range(6)]
        rng = np.random.default_rng(2)
        bad = [rng.integers(0, 4, 144).astype(np.uint8) for _ in range(12)]
        more = [voice_frame(s % 2, payload, sync=True) for s in range(6)]
        dec = make_decoder()
        out = dec.process(np.concatenate(good + bad + more))
        # decoder must survive the dropout and decode the tail again
        assert len(out) >= 27 * 8

    def test_streaming_equals_oneshot(self):
        lc = group_lc(10, 20)
        payload = np.tile([2, 0, 1, 3], 27)
        frames = (lead_in() + voice_superframe(0, lc, payload)
                  + [data_frame(s % 2, DATA_TYPE_TERMINATOR_LC, lc)
                     for s in range(2)])
        stream = np.concatenate(frames)
        whole = make_decoder().process(stream)
        dec = make_decoder()
        parts = b"".join(dec.process(stream[i:i + 101])
                         for i in range(0, len(stream), 101))
        assert whole == parts


def test_ms_sync_voice_decodes_like_bs():
    """Mobile-station sync patterns map to the same voice sync type
    (dmr_phase.hpp:25-28): an MS voice stream decodes identically."""
    from dmr_synth import voice_frame
    from digiham_jax.protocols.dmr import make_decoder
    payload = np.tile([2, 0, 3, 1], 27)
    bs = [voice_frame(s % 2, payload, sync=True) for s in range(8)]
    ms = [voice_frame(s % 2, payload, sync=True, ms=True)
          for s in range(8)]
    out_bs = make_decoder().process(np.concatenate(bs))
    out_ms = make_decoder().process(np.concatenate(ms))
    assert out_ms == out_bs and len(out_ms) >= 4 * 27
