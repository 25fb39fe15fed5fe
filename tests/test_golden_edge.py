"""Golden edge-case tests: paths the main fuzz doesn't reach — GPS
coordinate formatting (float math + to_string rounding), talker alias
formats, YSF V1/VW voice modes, D-Star NMEA/D-PRS."""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_golden_reference import compare

# every test here runs the compiled reference: skip, not fail, when the
# reference source tree is absent (tests/conftest.py)
pytestmark = pytest.mark.usefixtures("ref_harness")

import dmr_synth
from dmr_synth import (data_frame, embedded_fragments, make_lc_bytes,
                       voice_frame, voice_superframe)
from digiham_jax.protocols.dmr.components import (LC_GPS_INFO,
                                                  LC_TALKER_ALIAS_HDR)


class TestDmrGpsGolden:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_gps_coordinates(self, seed, tmp_path):
        """Random 24/25-bit lat/lon values: float math and the 6-decimal
        to_string formatting must match the C++ exactly."""
        from digiham_jax.protocols.dmr import make_decoder
        rng = np.random.default_rng(seed)
        payload = bytes([int(rng.integers(0, 256)) for _ in range(7)])
        lc = make_lc_bytes(LC_GPS_INFO, payload)
        frames = [data_frame(s % 2, 1, lc) for s in range(6)]
        stream = np.concatenate(frames)
        compare("dmr", make_decoder, stream, tmp_path)


class TestDmrAliasGolden:
    @pytest.mark.parametrize("fmt,text", [
        (1, b"DL1ABC"),            # 8-bit ISO
        (1, b"K\xdcRT"),           # 8-bit with non-ASCII (latin-1 U-umlaut)
        (2, "DK5ÄB".encode("utf-8")[:6]),   # UTF-8
    ])
    def test_alias_formats(self, fmt, text, tmp_path):
        """Talker alias via voice-header LCs in a superframe stream."""
        from digiham_jax.protocols.dmr import make_decoder
        hdr = bytes([(fmt << 6) | (len(text) << 1)]) + text[:6].ljust(6, b"\x00")
        blk1 = (text[6:] if len(text) > 6 else b"").ljust(7, b"\x00")
        lc_hdr = make_lc_bytes(LC_TALKER_ALIAS_HDR, hdr[:7])
        lc_blk = make_lc_bytes(LC_TALKER_ALIAS_HDR + 1, blk1)
        frames = [data_frame(s % 2, 1, lc_hdr) for s in range(4)]
        frames += [data_frame(s % 2, 1, lc_blk) for s in range(2)]
        stream = np.concatenate(frames)
        compare("dmr", make_decoder, stream, tmp_path)


class TestDmrAlias7bitUtf16Golden:
    def test_7bit_alias(self, tmp_path):
        """Format 0: 7-bit packed chars across header+blocks."""
        from digiham_jax.protocols.dmr import make_decoder
        text = "DL7BIT/ALIAS"
        # pack: header byte + 7-bit chars; first output char is built from
        # header bits, so prepend a dummy char position
        bits = []
        hdr_byte = (0 << 6) | (len(text) << 1)
        stream_bytes = bytearray()
        allchars = "\x00" + text  # char 0 overlaps the header byte
        bitstr = ""
        for c in allchars:
            bitstr += format(ord(c), "07b")
        bitstr = format(hdr_byte, "08b")[:1] + bitstr  # keep MSB of header
        # simpler: build the 28-byte field directly via the inverse of
        # convert7BitData: res[k] bits packed MSB-first 7 bits each
        packed = bytearray(28)
        full = "".join(format(ord(c), "07b") for c in allchars)
        full = full.ljust(28 * 8, "0")
        for i in range(28 * 8):
            if full[i] == "1":
                packed[i // 8] |= 1 << (7 - i % 8)
        packed[0] = hdr_byte  # header byte occupies byte 0 entirely
        lcs = [make_lc_bytes(LC_TALKER_ALIAS_HDR + b, bytes(packed[b*7:b*7+7]))
               for b in range(3)]
        frames = []
        for lc in lcs:
            frames += [data_frame(s % 2, 1, lc) for s in range(2)]
        stream = np.concatenate(frames)
        compare("dmr", make_decoder, stream, tmp_path)

    def test_utf16_alias(self, tmp_path):
        from digiham_jax.protocols.dmr import make_decoder
        text = "UTF16A"
        enc = text.encode("utf-16-be")
        hdr = bytes([(3 << 6) | (len(text) << 1)]) + enc[:6]
        blk1 = enc[6:12].ljust(7, b"\x00")
        lcs = [make_lc_bytes(LC_TALKER_ALIAS_HDR, hdr[:7]),
               make_lc_bytes(LC_TALKER_ALIAS_HDR + 1, blk1)]
        frames = []
        for lc in lcs:
            frames += [data_frame(s % 2, 1, lc) for s in range(2)]
        stream = np.concatenate(frames)
        compare("dmr", make_decoder, stream, tmp_path)


class TestPocsagLimitsGolden:
    def test_long_message_truncation(self, tmp_path):
        """A message beyond MAX_MESSAGE_LENGTH exercises the pos+20
        boundary (message.cpp:28)."""
        from digiham_jax.protocols.pocsag import make_decoder
        from test_pocsag import (IDLE_CODEWORD, address_codeword,
                                 alpha_payloads, build_stream, data_codeword)
        text = "X" * 120  # 120*7 bits > 80*7 limit
        cws = [address_codeword(7, 3)]
        cws.extend(data_codeword(p) for p in alpha_payloads(text))
        cws.append(IDLE_CODEWORD)
        stream = build_stream(cws)
        compare("pocsag", make_decoder, stream, tmp_path)


class TestYsfModesGolden:
    def _frame_with_fich(self, data_type, payload_dibits):
        from ysf_synth import make_fich_word
        from digiham_jax.protocols.ysf.fich import encode_fich
        from digiham_jax.protocols.ysf.phases import (FICH_SIZE, FRAME_SIZE,
                                                      SYNC_SIZE, YSF_SYNC)
        frame = np.zeros(FRAME_SIZE, np.uint8)
        frame[:SYNC_SIZE] = YSF_SYNC
        frame[SYNC_SIZE:SYNC_SIZE + FICH_SIZE] = encode_fich(
            make_fich_word(1, data_type))
        frame[SYNC_SIZE + FICH_SIZE:] = payload_dibits
        return frame

    @pytest.mark.parametrize("data_type", [0, 1, 3])
    def test_v1_fr_and_datafr_modes(self, data_type, tmp_path):
        """V/D1 (incl. the reference's `=` packing quirk), VW full-rate,
        and FR-data stub against the reference."""
        from digiham_jax.protocols.ysf import make_decoder
        rng = np.random.default_rng(data_type)
        frames = [self._frame_with_fich(
            data_type, rng.integers(0, 4, 360).astype(np.uint8))
            for _ in range(4)]
        stream = np.concatenate(frames + [np.zeros(481, np.uint8)])
        compare("ysf", make_decoder, stream, tmp_path)

    def test_vw_subframe_after_header(self, tmp_path):
        """HEADER then VW: expectSubFrame skips the first 3 blocks
        (ysf_phase.cpp:113-118)."""
        from digiham_jax.protocols.ysf import make_decoder
        from ysf_synth import header_frame
        rng = np.random.default_rng(7)
        frames = [np.asarray(header_frame(b"A", b"B", b"C", b"D"), np.uint8)]
        frames += [self._frame_with_fich(
            3, rng.integers(0, 4, 360).astype(np.uint8)) for _ in range(3)]
        stream = np.concatenate(frames + [np.zeros(481, np.uint8)])
        compare("ysf", make_decoder, stream, tmp_path)


class TestDstarTextGolden:
    def _slow_data_stream(self, sentence: bytes):
        from test_dstar import full_voice_stream
        frames = {}
        pieces = [sentence[i:i + 5] for i in range(0, len(sentence), 5)]
        fc = 0
        for piece in pieces:
            if fc >= 20:
                break
            frames[fc] = bytes([0x30 | len(piece)]) + piece[:2]
            frames[fc + 1] = (piece[2:] + b"\x00" * 3)[:3]
            fc += 2
        return np.concatenate(
            full_voice_stream(24, message_frames=frames)
            + [np.zeros(250, np.uint8)])

    def test_nmea_gga(self, tmp_path):
        """NMEA GGA coordinate parsing + float formatting vs reference."""
        from digiham_jax.protocols.dstar import make_decoder
        body = b"GPGGA,1234,4217.24,N,07153.6,W,1*"
        checksum = 0
        for ch in body[:-1]:
            checksum ^= ch
        sentence = b"$" + body + f"{checksum:02X}".encode() + b"\r"
        stream = self._slow_data_stream(sentence)
        out = compare("dstar", make_decoder, stream, tmp_path)

    def test_dprs(self, tmp_path):
        from digiham_jax.fec.crc import crc16_dstar
        from digiham_jax.protocols.dstar import make_decoder
        dprs_body = b"W1AW>API705,DSTAR*:!4217.24N\r"
        bits = np.unpackbits(np.frombuffer(dprs_body, np.uint8),
                             bitorder="little")
        crc = int(crc16_dstar(len(bits)).compute_np(bits))
        sentence = b"$$CRC%04X," % crc + dprs_body
        stream = self._slow_data_stream(sentence)
        compare("dstar", make_decoder, stream, tmp_path)


class TestDstarInlineHeaderGolden:
    def test_inline_header_via_slow_data(self, tmp_path):
        """Mini-header 0x5: a 41-byte radio header re-assembled from slow
        data and re-parsed (dstar_phase.cpp:165-176 + header reparse)."""
        from digiham_jax.protocols.dstar import make_decoder
        from digiham_jax.fec.crc import crc16_dstar
        from test_dstar import full_voice_stream, make_header_bytes
        hdr39 = make_header_bytes(own="N0CALL", suffix="ID")
        bits = np.unpackbits(np.frombuffer(hdr39, np.uint8),
                             bitorder="little")
        crc = int(crc16_dstar(len(bits)).compute_np(bits))
        hdr41 = hdr39 + bytes([crc & 0xFF, (crc >> 8) & 0xFF])
        frames = {}
        fc = 0
        for i in range(0, 41, 5):
            if fc >= 20:
                break
            chunk = hdr41[i:i + 5]
            frames[fc] = (bytes([0x50 | len(chunk)])
                          + chunk[:2]).ljust(3, b"\x00")
            frames[fc + 1] = (chunk[2:] + b"\x00" * 3)[:3]
            fc += 2
        # 41 bytes need 9 chunks = 18 frames; fits in one 20-frame cycle
        stream = np.concatenate(
            full_voice_stream(24, message_frames=frames)
            + [np.zeros(250, np.uint8)])
        out = compare("dstar", make_decoder, stream, tmp_path)
        assert len(out) > 0


class TestMsSyncGolden:
    def test_ms_voice_stream(self, tmp_path):
        """Mobile-station sync patterns (dmr_phase.hpp:25-28) vs the
        reference binary."""
        from digiham_jax.protocols.dmr import make_decoder
        payload = np.tile([2, 0, 3, 1], 27)
        stream = np.concatenate(
            [voice_frame(s % 2, payload, sync=True, ms=True)
             for s in range(8)])
        out = compare("dmr", make_decoder, stream, tmp_path)
        assert len(out) >= 4 * 27


class TestNxdnChannelTypesGolden:
    def test_rcch_udch_skipped(self, tmp_path):
        """RCCH rf-type and UDCH functional-type frames skip SACCH/slot
        decode (nxdn_phase.cpp:55-174 gate) — byte-identical behavior."""
        from digiham_jax.protocols.nxdn import make_decoder
        from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                                vcall_superframe_bytes, voice_slot_dibits)
        units = vcall_superframe_bytes(1, 77, 88)
        payload72 = np.tile([1, 3, 0, 2], 18).astype(np.uint8)
        parts = [np.zeros(60, np.uint8)]
        for i in range(8):
            lich = ((0b00, 0b10, 0b11) if i % 2 else (0b01, 0b01, 0b11)) \
                if i % 3 == 2 else (0b01, 0b10, 0b11)
            parts.append(nxdn_frame(
                lich, encode_sacch_unit(i % 4, units[i % 4]),
                [voice_slot_dibits(payload72, 38),
                 voice_slot_dibits(payload72, 110)]))
        parts.append(np.zeros(400, np.uint8))
        out = compare("nxdn", make_decoder,
                      np.concatenate(parts), tmp_path)
        assert len(out) > 0


class TestDstarHalfTerminator:
    def test_half_length_terminator(self, tmp_path):
        """A frame whose 24 data bits alone match the terminator's second
        half ends the stream (dstar_phase.cpp:96-100) even when the full
        48-bit window doesn't match."""
        from digiham_jax.protocols.dstar import make_decoder
        from digiham_jax.protocols.dstar.phases import TERMINATOR
        from test_dstar import full_voice_stream
        parts = full_voice_stream(6)
        half_term = np.concatenate([
            np.unpackbits(np.frombuffer(b"\x55" * 9, np.uint8),
                          bitorder="little"),
            TERMINATOR[24:],
        ])
        parts += [half_term, np.ones(300, np.uint8)]
        out = compare("dstar", make_decoder,
                      np.concatenate(parts).astype(np.uint8), tmp_path)
        assert len(out) >= 9 * 5


class TestYsfTestChannelGolden:
    def test_test_channel_ignored(self, tmp_path):
        """FRAME_TYPE_TEST_CHANNEL (fich.hpp) falls through every dispatch
        branch — byte-identical no-op between voice frames."""
        from digiham_jax.protocols.ysf import make_decoder
        from ysf_synth import make_fich_word, vd2_frame
        from digiham_jax.protocols.ysf.fich import encode_fich
        from digiham_jax.protocols.ysf.phases import (FICH_SIZE, FRAME_SIZE,
                                                      SYNC_SIZE, YSF_SYNC)
        test_frame = np.zeros(FRAME_SIZE, np.uint8)
        test_frame[:SYNC_SIZE] = YSF_SYNC
        test_frame[SYNC_SIZE:SYNC_SIZE + FICH_SIZE] = encode_fich(
            make_fich_word(3, 2))
        stream = np.concatenate(
            [vd2_frame(0, b"BEFORE    "), test_frame,
             vd2_frame(1, b"AFTER     "), np.zeros(481, np.uint8)])
        out = compare("ysf", make_decoder, stream, tmp_path)
        assert len(out) > 0
