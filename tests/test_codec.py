"""Codec bridge tests: protobuf wire codec + full MbeSynthesizer protocol
against a loopback mock codecserver."""
import socket
import threading

import pytest

from digiham_jax.codec import (
    ControlWordMode,
    DynamicMode,
    MbeSynthesizer,
    TableMode,
)
from digiham_jax.codec import proto
from digiham_jax.codec.modes import (
    DMR_NXDN_TABLE_INDEX,
    DSTAR_CONTROL_WORDS,
    YSF_DN_TABLE_INDEX,
    YSF_FRAME_SIZES,
    ysf_mode_for,
)


class TestProtoWire:
    def test_varint_roundtrip(self):
        import io
        for v in (0, 1, 127, 128, 300, 1 << 20, (1 << 35) + 7):
            out = io.BytesIO()
            proto.write_varint(out, v)
            got, pos = proto.read_varint(out.getvalue(), 0)
            assert got == v and pos == len(out.getvalue())

    def test_any_roundtrip(self):
        msg = proto.Request("ambe", proto.Settings(
            args={"index": "33"}))
        framed = proto.frame_message(msg)
        length, pos = proto.read_varint(framed, 0)
        decoded = proto.unpack_any(framed[pos:pos + length])
        assert isinstance(decoded, proto.Request)
        assert decoded.codec == "ambe"
        assert decoded.settings.args == {"index": "33"}

    def test_response_with_framing(self):
        msg = proto.Response(proto.STATUS_OK, framing=proto.FramingHint(9, 320))
        decoded = proto.Response.parse(msg.serialize())
        assert decoded.framing.channel_bytes == 9
        assert decoded.framing.audio_bytes == 320

    def test_speech_data(self):
        msg = proto.SpeechData(b"\x01\x02" * 160)
        assert proto.SpeechData.parse(msg.serialize()).data == b"\x01\x02" * 160


class TestModes:
    def test_control_word_string(self):
        mode = ControlWordMode(DSTAR_CONTROL_WORDS)
        assert mode.get_cwds_as_string() == "0130:0763:4000:0000:0000:0048"

    def test_mode_equality(self):
        assert TableMode(33) == TableMode(33)
        assert TableMode(33) != TableMode(34)
        assert ControlWordMode(DSTAR_CONTROL_WORDS) == \
            ControlWordMode(DSTAR_CONTROL_WORDS)
        d = DynamicMode(lambda c: None)
        assert d == d

    def test_ysf_mapping(self):
        assert ysf_mode_for(0) == TableMode(DMR_NXDN_TABLE_INDEX)
        assert ysf_mode_for(2) == TableMode(YSF_DN_TABLE_INDEX)
        assert isinstance(ysf_mode_for(3), ControlWordMode)
        assert ysf_mode_for(7) is None
        assert YSF_FRAME_SIZES == {0: 9, 2: 7, 3: 18}


class MockCodecServer(threading.Thread):
    """Loopback server speaking the framed-Any dialect: echoes each
    ChannelData frame back as SpeechData of 2x the length (fake PCM)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.listener, self.client_sock = socket.socketpair()
        self.requests = []
        self.renegotiations = []
        self.framing_by_args = {
            "33": 9, "34": 7,
        }

    def _framing_for(self, args):
        if "index" in args:
            return proto.FramingHint(self.framing_by_args[args["index"]], 320)
        return proto.FramingHint(9 if args.get("ratep", "").startswith("0130")
                                 else 18, 320)

    def run(self):
        from digiham_jax.codec.mbe import _Connection
        conn = _Connection(self.listener)
        try:
            self._serve(conn)
        except OSError:
            pass  # client closed mid-reply
        self.listener.close()

    def _serve(self, conn):
        conn.send_message(proto.Handshake("mock-1.0", "1.0"))
        while True:
            msg = conn.receive_message()
            if msg is None:
                break
            if isinstance(msg, proto.Check):
                conn.send_message(proto.Response(proto.STATUS_OK))
            elif isinstance(msg, proto.Request):
                self.requests.append(msg.settings.args)
                conn.send_message(proto.Response(
                    proto.STATUS_OK,
                    framing=self._framing_for(msg.settings.args)))
            elif isinstance(msg, proto.Renegotiation):
                self.renegotiations.append(msg.settings.args)
                conn.send_message(proto.Response(
                    proto.STATUS_OK,
                    framing=self._framing_for(msg.settings.args)))
            elif isinstance(msg, proto.ChannelData):
                conn.send_message(proto.SpeechData(msg.data * 2))


def make_pair():
    server = MockCodecServer()
    server.start()
    synth = MbeSynthesizer(server.client_sock)
    return server, synth


class TestMbeSynthesizer:
    def test_handshake_and_check(self):
        server, synth = make_pair()
        assert synth.has_ambe_codec()
        synth.close()

    def test_table_mode_stream(self):
        server, synth = make_pair()
        synth.set_mode(TableMode(33))
        assert synth.channel_bytes() == 9
        n = synth.process(b"\xAB" * 27)  # 3 frames
        assert n == 3
        import time
        deadline = time.time() + 5
        pcm = b""
        while len(pcm) < 54 and time.time() < deadline:
            pcm += synth.read_pcm()
            time.sleep(0.01)
        assert pcm == b"\xAB" * 54
        assert server.requests == [{"index": "33"}]
        synth.close()

    def test_dynamic_mode_renegotiates(self):
        server, synth = make_pair()
        synth.set_mode(DynamicMode(ysf_mode_for))
        # initial request is mode-for-code-0 => index 33, 9 bytes/frame
        assert synth.channel_bytes() == 9
        # DN frame: mode byte 2 + 7 payload bytes triggers renegotiation
        n = synth.process(bytes([2]) + b"\x11" * 7)
        assert n == 1
        assert synth.channel_bytes() == 7
        assert server.renegotiations == [{"index": "34"}]
        # back to V/D1
        n = synth.process(bytes([0]) + b"\x22" * 9)
        assert n == 1
        assert synth.channel_bytes() == 9
        synth.close()

    def test_partial_frames_buffered(self):
        server, synth = make_pair()
        synth.set_mode(TableMode(33))
        assert synth.process(b"\x01" * 5) == 0
        assert synth.process(b"\x01" * 4) == 1
        synth.close()
