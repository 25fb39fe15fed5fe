"""YSF decoder tests: synthesized frames -> voice blocks + metadata."""
import numpy as np
import pytest

from digiham_jax.protocols.ysf import make_decoder
from digiham_jax.protocols.ysf.fich import Fich, encode_fich
from digiham_jax.protocols.ysf.phases import (
    decode_v2_voice,
    treat_ysf_string,
)
from digiham_jax.runtime.meta import PipelineMetaWriter

from ysf_synth import (
    encode_v2_voice,
    header_frame,
    make_fich_word,
    terminator_frame,
    vd2_frame,
)


def attach_meta(dec):
    events = []
    dec.set_meta_writer(PipelineMetaWriter(lambda b: events.append(b.decode())))
    return events


class TestFich:
    def test_roundtrip(self):
        word = make_fich_word(1, 2, 5)
        fich = Fich.parse(encode_fich(word))
        assert fich is not None
        assert fich.frame_type() == 1
        assert fich.data_type() == 2
        assert fich.frame_number() == 5

    def test_corrupt_dibits_corrected(self):
        word = make_fich_word(1, 2, 3)
        dibits = encode_fich(word)
        dibits[7] ^= 1  # a couple of single-bit symbol errors
        dibits[60] ^= 2
        fich = Fich.parse(dibits)
        assert fich is not None and fich.frame_number() == 3

    def test_heavy_corruption_rejected(self):
        rng = np.random.default_rng(0)
        dibits = rng.integers(0, 4, 100).astype(np.uint8)
        # random dibits: golay+crc should reject
        assert Fich.parse(dibits) is None


class TestVoice:
    def test_v2_voice_roundtrip(self):
        ambe = bytes([0x12, 0x34, 0x56, 0x78, 0x9A, 0xBC, 0xDE])
        dibits = encode_v2_voice(ambe)
        got = decode_v2_voice(dibits)
        # only 49 bits are significant; compare those
        want_bits = np.unpackbits(np.frombuffer(ambe, np.uint8))[:49]
        got_bits = np.unpackbits(np.frombuffer(got, np.uint8))[:49]
        np.testing.assert_array_equal(got_bits, want_bits)

    def test_tribit_majority_corrects(self):
        ambe = bytes(7)
        dibits = encode_v2_voice(ambe).copy()
        # flipping one dibit corrupts 2 bits of the tribit stream; the
        # majority vote must still recover the protected 27 bits
        got0 = decode_v2_voice(dibits)
        dibits[5] ^= 3
        got1 = decode_v2_voice(dibits)
        b0 = np.unpackbits(np.frombuffer(got0, np.uint8))
        b1 = np.unpackbits(np.frombuffer(got1, np.uint8))
        # the first 27 voice bits sit at mapped positions; majority keeps
        # at least 26 of 27 intact
        assert (b0 != b1).sum() <= 2


class TestEndToEnd:
    def test_vd2_stream_voice_and_dch(self):
        frames = [
            vd2_frame(0, b"ALL       "),
            vd2_frame(1, b"DG1ABC    "),
            vd2_frame(2, b"GATEWAY   "),
            vd2_frame(3, b"DG1ABC-ND "),
            vd2_frame(4, b"          "),
            terminator_frame(),  # flushes the 5th frame out of the buffer
        ]
        dec = make_decoder()
        events = attach_meta(dec)
        out = dec.process(np.concatenate(frames))
        # 5 frames x 5 blocks x (1 mode byte + 7 ambe bytes)
        assert len(out) == 5 * 5 * 8
        assert out[0] == 2  # DN mode byte
        # voice block carries the 49 significant AMBE bits
        want = np.unpackbits(np.frombuffer(b"\x55" * 7, np.uint8))[:49]
        got = np.unpackbits(np.frombuffer(out[1:8], np.uint8))[:49]
        np.testing.assert_array_equal(got, want)
        assert any("mode:DN" in e for e in events)
        assert any("target:ALL" in e for e in events)
        assert any("source:DG1ABC" in e and "protocol:YSF" in e
                   for e in events)
        assert any("down:GATEWAY" in e for e in events)
        assert any("up:DG1ABC-ND" in e for e in events)

    def test_header_frame_metadata(self):
        frames = [
            header_frame(b"ALL", b"W1AW", b"GW-1", b"UPLINK"),
            vd2_frame(0, b"ALL       "),
        ]
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(np.concatenate(frames))
        assert any("target:ALL" in e and "source:W1AW" in e for e in events)
        assert any("down:GW-1" in e and "up:UPLINK" in e for e in events)

    def test_terminator_resets(self):
        frames = [
            vd2_frame(1, b"DG1ABC    "),
            terminator_frame(),
            terminator_frame(),  # padding: a frame only decodes once the
                                 # buffer holds MORE than one frame
        ]
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(np.concatenate(frames))
        # last event should have cleared source
        assert "source:" not in events[-1]

    def test_sync_acquisition_after_noise(self):
        rng = np.random.default_rng(1)
        noise = rng.integers(0, 4, 777).astype(np.uint8)
        frames = [vd2_frame(i % 8, b"TEST      ") for i in range(3)]
        dec = make_decoder()
        out = dec.process(np.concatenate([noise] + frames))
        assert len(out) >= 2 * 5 * 8

    def test_streaming_equals_oneshot(self):
        frames = [header_frame(b"ALL", b"W1AW", b"A", b"B")] + [
            vd2_frame(i, b"PAYLOAD   ") for i in range(4)] + [
            terminator_frame()]
        stream = np.concatenate(frames)
        whole = make_decoder().process(stream)
        dec = make_decoder()
        parts = b"".join(dec.process(stream[i:i + 133])
                         for i in range(0, len(stream), 133))
        assert whole == parts


class TestStrings:
    def test_treat_ysf_string(self):
        assert treat_ysf_string(b"DG1ABC    ") == "DG1ABC"
        assert treat_ysf_string(b"AB\nCDEFGHI") == "AB"
        assert treat_ysf_string(b"0123456789") == "0123456789"


class TestV1AndVwModes:
    def test_v1_stream(self):
        """V/D1 frames: mode byte 0 + 9 bytes per block, 'V1' metadata.
        NB the reference's `=` vs `|=` packing quirk means only the last
        dibit of each group of 4 lands in the byte (ysf_phase.cpp:175)."""
        from ysf_synth import v1_frame
        voice36 = np.tile([1, 2, 3, 0], 9)
        from ysf_synth import terminator_frame
        frames = [v1_frame(i, voice36) for i in range(3)]
        # terminator then pad: flushes the 1-frame lookahead without the
        # trailing zeros being decoded as voice under sync hysteresis
        frames += [terminator_frame(), np.zeros(481, np.uint8)]
        dec = make_decoder()
        events = attach_meta(dec)
        out = dec.process(np.concatenate(frames))
        assert len(out) == 3 * 5 * 10
        assert out[0] == 0  # V/D1 mode byte
        # `=` packing: byte k keeps only dibit 4k+3 at shift 0
        assert out[1:10] == bytes([0] * 9)
        assert any("mode:V1" in e for e in events)

    def test_vw_stream_and_header_subframe_skip(self):
        """VW frames: 18 raw bytes per block; after a header the first
        frame skips blocks 0-2 (expect_sub_frame, ysf_phase.cpp:122)."""
        from ysf_synth import header_frame, vw_frame
        from ysf_synth import terminator_frame
        parts = [header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  "),
                 vw_frame(0), vw_frame(1), terminator_frame(),
                 np.zeros(481, np.uint8)]
        dec = make_decoder()
        events = attach_meta(dec)
        out = dec.process(np.concatenate(parts))
        # first VW frame after header: blocks 3..4 only; second: all 5
        assert len(out) == (2 + 5) * 19
        assert out[0] == 3  # VW mode byte
        assert out[1:19] == b"\xA5" * 18
        assert any("mode:VW" in e for e in events)
