"""D-Star decoder tests: header codec roundtrip, voice stream, slow data."""
import numpy as np
import pytest

from digiham_jax.fec.crc import crc16_dstar
from digiham_jax.fec.lfsr import dstar_scrambler
from digiham_jax.protocols.dstar import make_decoder
from digiham_jax.protocols.dstar.header import (
    Header,
    encode_header,
)
from digiham_jax.protocols.dstar.phases import (
    HEADER_SYNC,
    TERMINATOR,
    VOICE_SYNC,
)
from digiham_jax.runtime.meta import PipelineMetaWriter


def make_header_bytes(dest="DIRECT", dep="DIRECT", companion="CQCQCQ",
                      own="W1AW", suffix="705", voice=True):
    data = bytearray(39)
    data[0] = 0 if voice else 0x80
    data[3:11] = dest.ljust(8).encode()[:8]
    data[11:19] = dep.ljust(8).encode()[:8]
    data[19:27] = companion.ljust(8).encode()[:8]
    data[27:35] = own.ljust(8).encode()[:8]
    data[35:39] = suffix.ljust(4).encode()[:4]
    return bytes(data)


def scramble24(data3: bytes) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data3, np.uint8), bitorder="little")
    return bits ^ dstar_scrambler()[:24]


def voice_frame(voice9: bytes = b"\xAA" * 9, data3: bytes = b"\x66" * 3,
                raw_data24=None) -> np.ndarray:
    voice_bits = np.unpackbits(np.frombuffer(voice9, np.uint8),
                               bitorder="little")
    if raw_data24 is None:
        raw_data24 = scramble24(data3)
    return np.concatenate([voice_bits, raw_data24])


def attach_meta(dec):
    events = []
    dec.set_meta_writer(PipelineMetaWriter(lambda b: events.append(b.decode())))
    return events


def bit_sync_preamble(n=64):
    return np.tile(np.array([1, 0], np.uint8), n // 2)


def full_voice_stream(n_frames=25, message_frames=None):
    """header sync + header + n voice frames (sync frame every 21st)."""
    parts = [bit_sync_preamble(), HEADER_SYNC,
             encode_header(make_header_bytes())]
    fc = 20  # a voice sync is due immediately after the header
    for i in range(n_frames):
        if fc >= 20:
            parts.append(voice_frame(raw_data24=VOICE_SYNC))
            fc = 0
        else:
            data3 = b"\x66\x66\x66"
            if message_frames and fc in message_frames:
                data3 = message_frames[fc]
            parts.append(voice_frame(data3=data3))
            fc += 1
    return parts


class TestHeader:
    def test_roundtrip(self):
        raw = encode_header(make_header_bytes())
        h = Header.parse_from_header(raw)
        assert h is not None
        assert h.is_voice()
        assert h.destination_repeater() == "DIRECT"
        assert h.own_callsign() == "W1AW/705"
        assert h.companion() == "CQCQCQ"

    def test_bit_errors_corrected(self):
        raw = encode_header(make_header_bytes()).copy()
        rng = np.random.default_rng(0)
        for pos in rng.choice(660, size=8, replace=False):
            raw[pos] ^= 1
        h = Header.parse_from_header(raw)
        assert h is not None
        assert h.own_callsign() == "W1AW/705"

    def test_garbage_rejected(self):
        rng = np.random.default_rng(1)
        raw = rng.integers(0, 2, 660).astype(np.uint8)
        assert Header.parse_from_header(raw) is None

    def test_data_header(self):
        raw = encode_header(make_header_bytes(voice=False))
        h = Header.parse_from_header(raw)
        assert h is not None and h.is_data()


class TestEndToEnd:
    def test_header_then_voice(self):
        stream = np.concatenate(
            full_voice_stream(24) + [np.zeros(200, np.uint8)])
        dec = make_decoder()
        events = attach_meta(dec)
        out = dec.process(stream)
        assert len(out) % 9 == 0 and len(out) >= 9 * 20
        # voice bytes are 0xAA packed LSB-first
        assert out[:9] == b"\xAA" * 9
        assert any("ourcall:W1AW/705" in e and "sync:voice" in e
                   for e in events)
        assert any("protocol:DSTAR" in e for e in events)

    def test_terminator_ends_stream(self):
        parts = full_voice_stream(5)
        term_frame = np.concatenate([
            np.unpackbits(np.frombuffer(b"\xAA" * 9, np.uint8),
                          bitorder="little"),
            TERMINATOR,
        ])
        parts.append(term_frame)
        parts.append(np.zeros(300, np.uint8))
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(np.concatenate(parts))
        assert "ourcall:" not in events[-1]  # reset after terminator

    def test_dstar_message(self):
        """20-char message via mini-header 0x4 slow data frames."""
        text = b"HELLO FROM DSTAR  !!"
        msg_frames = {}
        # frames come in pairs: even frame -> 3 bytes, odd -> 3 bytes
        for block in range(4):
            chunk = text[block * 5:block * 5 + 5]
            even = bytes([0x40 | block]) + chunk[:2]
            odd = chunk[2:5]
            msg_frames[block * 2] = even
            msg_frames[block * 2 + 1] = odd
        stream = np.concatenate(
            full_voice_stream(24, message_frames=msg_frames)
            + [np.zeros(200, np.uint8)])
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(stream)
        assert any(f"message:{text.decode()}" in e for e in events)

    def test_voice_sync_entry(self):
        """Entering via voice sync (no header): voice output begins after
        the sync confirms."""
        parts = [bit_sync_preamble(), VOICE_SYNC]
        for i in range(21):
            if i and i % 21 == 20:
                parts.append(voice_frame(raw_data24=VOICE_SYNC))
            else:
                parts.append(voice_frame())
        parts.append(voice_frame(raw_data24=VOICE_SYNC))
        parts.append(np.zeros(200, np.uint8))
        dec = make_decoder()
        out = dec.process(np.concatenate(parts))
        # voice only emitted after the first in-stream re-sync
        assert len(out) % 9 == 0

    def test_streaming_equals_oneshot(self):
        stream = np.concatenate(
            full_voice_stream(23) + [np.zeros(250, np.uint8)])
        whole = make_decoder().process(stream)
        dec = make_decoder()
        parts = b"".join(dec.process(stream[i:i + 97])
                         for i in range(0, len(stream), 97))
        assert whole == parts


class TestDprs:
    def test_dprs_crc(self):
        """$$CRC slow data -> dprs metadata."""
        body = b"W1AW>API705,DSTAR*:!4217.24N/07153.63W\r"
        bits = np.unpackbits(np.frombuffer(body, np.uint8),
                             bitorder="little")
        crc = int(crc16_dstar(len(bits)).compute_np(bits))
        sentence = b"$$CRC%04X," % crc + body
        frames = {}
        # chunk into 5-byte pieces across frame pairs (mini header 0x3)
        pieces = [sentence[i:i + 5] for i in range(0, len(sentence), 5)]
        fc = 0
        for piece in pieces:
            frames[fc] = bytes([0x30 | len(piece)]) + piece[:2]
            frames[fc + 1] = (piece[2:] + b"\x00" * 3)[:3]
            fc += 2
        assert fc <= 20
        stream = np.concatenate(
            full_voice_stream(24, message_frames=frames)
            + [np.zeros(200, np.uint8)])
        dec = make_decoder()
        events = attach_meta(dec)
        dec.process(stream)
        assert any("dprs:W1AW>API705" in e for e in events)
