"""NXDN decoder tests, including the reference's embedded golden SACCH
vectors from the NXDN Common Air Interface Test document
(src/nxdn_decoder/nxdn_phase.cpp:77-103)."""
import numpy as np
import pytest

from digiham_jax.protocols.nxdn import make_decoder
from digiham_jax.protocols.nxdn.components import (
    CALL_TYPE_CONFERENCE,
    Facch1,
    Lich,
    MESSAGE_TYPE_IDLE,
    MESSAGE_TYPE_TX_RELEASE,
    MESSAGE_TYPE_VCALL,
    RF_CHANNEL_TYPE_RTCH,
    Sacch,
    SacchSuperframeCollector,
    Scrambler,
    USC_TYPE_SACCH_SF,
)
from digiham_jax.runtime.meta import PipelineMetaWriter

from nxdn_synth import (
    encode_facch1,
    encode_lich,
    encode_sacch_unit,
    nxdn_frame,
    vcall_superframe_bytes,
    voice_slot_dibits,
)

# golden vectors: descrambled SACCH dibits (nxdn_phase.cpp:77-103)
GOLDEN_SACCH = [
    [0b11, 0b00, 0b11, 0b11, 0b10, 0b10, 0b00, 0b00,
     0b10, 0b10, 0b01, 0b10, 0b11, 0b10, 0b10, 0b00,
     0b10, 0b10, 0b00, 0b10, 0b00, 0b11, 0b01, 0b01,
     0b01, 0b10, 0b11, 0b10, 0b10, 0b00],
    [0b11, 0b00, 0b01, 0b10, 0b11, 0b01, 0b10, 0b11,
     0b10, 0b11, 0b00, 0b00, 0b11, 0b10, 0b10, 0b11,
     0b00, 0b11, 0b10, 0b10, 0b01, 0b00, 0b00, 0b10,
     0b01, 0b10, 0b10, 0b10, 0b10, 0b00],
    [0b01, 0b10, 0b00, 0b11, 0b10, 0b10, 0b00, 0b01,
     0b10, 0b11, 0b01, 0b00, 0b10, 0b10, 0b10, 0b00,
     0b00, 0b01, 0b10, 0b10, 0b10, 0b00, 0b11, 0b10,
     0b00, 0b10, 0b10, 0b00, 0b00, 0b00],
    [0b01, 0b00, 0b00, 0b10, 0b10, 0b00, 0b10, 0b00,
     0b00, 0b11, 0b00, 0b00, 0b00, 0b10, 0b10, 0b11,
     0b00, 0b00, 0b00, 0b10, 0b11, 0b01, 0b00, 0b00,
     0b01, 0b11, 0b11, 0b10, 0b00, 0b10],
]


class TestGoldenSacch:
    """The reference embeds these as scrambled on-air captures: they stand
    in for ``sacch_raw`` *before* the in-frame descramble at keystream
    offset 8 (nxdn_phase.cpp:104-107)."""

    def test_golden_vectors_form_vcall_superframe(self):
        collector = SacchSuperframeCollector()
        for raw in GOLDEN_SACCH:
            sacch = Sacch.parse(
                Scrambler.descramble(np.array(raw, np.uint8), 8))
            assert sacch is not None, "golden SACCH unit failed to decode"
            collector.push(sacch)
        assert collector.is_complete()
        sf = collector.get_superframe()
        assert sf is not None
        assert sf.message_type() == MESSAGE_TYPE_VCALL
        # "sample VOICECALL information" per the CAI test document
        assert sf.call_type() == CALL_TYPE_CONFERENCE
        assert sf.source_unit_id() == 1
        assert sf.destination_id() == 1

    def test_structure_indices_sequential(self):
        indices = [
            Sacch.parse(
                Scrambler.descramble(np.array(r, np.uint8), 8)
            ).structure_index()
            for r in GOLDEN_SACCH]
        assert indices == [0, 1, 2, 3]


class TestComponents:
    def test_lich_roundtrip(self):
        dibits = encode_lich(RF_CHANNEL_TYPE_RTCH, USC_TYPE_SACCH_SF, 0b11)
        lich = Lich.parse(Scrambler.descramble(dibits, 0))
        assert lich is not None
        assert lich.rf_type() == RF_CHANNEL_TYPE_RTCH
        assert lich.functional_type() == USC_TYPE_SACCH_SF
        assert lich.option() == 0b11

    def test_lich_bad_parity_rejected(self):
        dibits = encode_lich(RF_CHANNEL_TYPE_RTCH, USC_TYPE_SACCH_SF, 0b11)
        clear = Scrambler.descramble(dibits, 0)
        clear[0] ^= 2  # flip a covered high bit
        assert Lich.parse(clear) is None

    def test_sacch_roundtrip(self):
        payload = np.ones(18, np.uint8)
        dibits = encode_sacch_unit(2, payload, scramble=False)
        sacch = Sacch.parse(dibits)
        assert sacch is not None
        assert sacch.structure_index() == 2
        np.testing.assert_array_equal(sacch.superframe_bits(), payload)

    def test_sacch_symbol_errors_mostly_corrected(self):
        """The punctured Viterbi corrects most single-symbol errors; sweep
        all 90 single-dibit corruptions and require a high fix rate with
        zero silent misdecodes."""
        payload = (np.arange(18) % 2).astype(np.uint8)
        fixed = 0
        for pos in range(30):
            for flip in (1, 2, 3):
                dibits = encode_sacch_unit(1, payload, scramble=False).copy()
                dibits[pos] ^= flip
                sacch = Sacch.parse(dibits)
                if sacch is not None:
                    np.testing.assert_array_equal(
                        sacch.superframe_bits(), payload)
                    assert sacch.structure_index() == 1
                    fixed += 1
        assert fixed >= 60

    def test_facch1_roundtrip(self):
        dibits = encode_facch1(MESSAGE_TYPE_TX_RELEASE, None)
        f = Facch1.parse(dibits)
        assert f is not None
        assert f.message_type() == MESSAGE_TYPE_TX_RELEASE


def attach_meta(dec):
    events = []
    dec.set_meta_writer(PipelineMetaWriter(lambda b: events.append(b.decode())))
    return events


def full_vcall_stream(source=1234, dest=567):
    """4 frames carrying a complete SACCH superframe + voice slots."""
    units = vcall_superframe_bytes(CALL_TYPE_CONFERENCE, source, dest)
    frames = []
    payload = (np.arange(72) % 4).astype(np.uint8)
    for i in range(4):
        sacch = encode_sacch_unit(i, units[i])
        slots = [voice_slot_dibits(payload, 38),
                 voice_slot_dibits(payload, 110)]
        frames.append(nxdn_frame(
            (RF_CHANNEL_TYPE_RTCH, USC_TYPE_SACCH_SF, 0b11), sacch, slots))
    return frames, payload


class TestEndToEnd:
    def test_vcall_with_voice(self):
        frames, payload = full_vcall_stream()
        # pad so every frame decodes
        stream = np.concatenate(
            frames + [np.zeros(200, np.uint8)])
        dec = make_decoder()
        events = attach_meta(dec)
        out = dec.process(stream)
        # 4 frames x 2 slots x 18 bytes
        assert len(out) == 4 * 2 * 18
        expected = bytearray(18)
        for k in range(72):
            expected[k // 4] |= (int(payload[k]) & 3) << (6 - (k % 4) * 2)
        assert out[:18] == bytes(expected)
        assert any("sync:voice" in e for e in events)
        assert any("source:1234" in e and "destination:567" in e
                   and "type:conference" in e for e in events)
        assert any("protocol:NXDN" in e for e in events)

    def test_tx_release_drops_to_sync(self):
        frames, _ = full_vcall_stream()
        release = nxdn_frame(
            (RF_CHANNEL_TYPE_RTCH, USC_TYPE_SACCH_SF, 0b00),
            encode_sacch_unit(0, np.zeros(18, np.uint8)),
            [encode_facch1(MESSAGE_TYPE_TX_RELEASE, 38), None])
        stream = np.concatenate(frames + [release, np.zeros(400, np.uint8)])
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(stream)
        # after TX_RELEASE the metadata resets (no source in last event)
        assert "source:" not in events[-1]

    def test_idle_facch_keeps_running(self):
        idle = nxdn_frame(
            (RF_CHANNEL_TYPE_RTCH, USC_TYPE_SACCH_SF, 0b10),
            encode_sacch_unit(0, np.zeros(18, np.uint8)),
            [voice_slot_dibits((np.arange(72) % 4), 38),
             encode_facch1(MESSAGE_TYPE_IDLE, 110)])
        stream = np.concatenate([idle] * 3 + [np.zeros(200, np.uint8)])
        out = make_decoder().process(stream)
        assert len(out) == 3 * 18  # slot 0 voice only

    def test_sync_acquisition_after_noise(self):
        rng = np.random.default_rng(5)
        noise = rng.integers(0, 4, 333).astype(np.uint8)
        frames, _ = full_vcall_stream()
        stream = np.concatenate([noise] + frames
                                + [np.zeros(200, np.uint8)])
        out = make_decoder().process(stream)
        assert len(out) >= 3 * 2 * 18

    def test_streaming_equals_oneshot(self):
        frames, _ = full_vcall_stream()
        stream = np.concatenate(frames + [np.zeros(250, np.uint8)])
        whole = make_decoder().process(stream)
        dec = make_decoder()
        parts = b"".join(dec.process(stream[i:i + 77])
                         for i in range(0, len(stream), 77))
        assert whole == parts
