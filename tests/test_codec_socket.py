"""MbeSynthesizer over a real unix socket (mock codecserver daemon)."""
import os
import socket
import tempfile
import threading
import time

import pytest

from digiham_jax.codec import MbeSynthesizer, TableMode
from digiham_jax.codec import proto
from digiham_jax.codec.mbe import _Connection


class UnixMockServer(threading.Thread):
    def __init__(self, path):
        super().__init__(daemon=True)
        self.path = path
        self.listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.listener.bind(path)
        self.listener.listen(1)

    def run(self):
        sock, _ = self.listener.accept()
        conn = _Connection(sock)
        try:
            conn.send_message(proto.Handshake("mock", "1.0"))
            while True:
                msg = conn.receive_message()
                if msg is None:
                    break
                if isinstance(msg, proto.Check):
                    conn.send_message(proto.Response(proto.STATUS_OK))
                elif isinstance(msg, proto.Request):
                    conn.send_message(proto.Response(
                        proto.STATUS_OK,
                        framing=proto.FramingHint(9, 320)))
                elif isinstance(msg, proto.ChannelData):
                    conn.send_message(proto.SpeechData(b"\x01\x02" * 160))
        except OSError:
            pass
        sock.close()
        self.listener.close()


def test_unix_socket_roundtrip():
    path = os.path.join(tempfile.mkdtemp(), "codecserver.sock")
    server = UnixMockServer(path)
    server.start()
    synth = MbeSynthesizer(path)
    synth.set_mode(TableMode(33))
    assert synth.channel_bytes() == 9
    assert synth.process(b"\xAA" * 9) == 1
    deadline = time.time() + 5
    pcm = b""
    while len(pcm) < 320 and time.time() < deadline:
        pcm += synth.read_pcm()
        time.sleep(0.01)
    assert pcm == b"\x01\x02" * 160
    synth.close()


def test_connect_failure_raises():
    from digiham_jax.codec.mbe import ConnectionError_
    with pytest.raises(ConnectionError_):
        MbeSynthesizer("/tmp/definitely-missing-codecserver.sock")


class TcpMockServer(threading.Thread):
    """Same protocol as UnixMockServer over TCP loopback (the
    reference's host:port mode, mbe_synthesizer.cpp:61-103)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(1)
        self.port = self.listener.getsockname()[1]

    def run(self):
        sock, _ = self.listener.accept()
        conn = _Connection(sock)
        try:
            conn.send_message(proto.Handshake("mock", "1.0"))
            while True:
                msg = conn.receive_message()
                if msg is None:
                    break
                if isinstance(msg, proto.Check):
                    conn.send_message(proto.Response(proto.STATUS_OK))
                elif isinstance(msg, proto.Request):
                    conn.send_message(proto.Response(
                        proto.STATUS_OK,
                        framing=proto.FramingHint(9, 320)))
                elif isinstance(msg, proto.ChannelData):
                    conn.send_message(proto.SpeechData(b"\x03\x04" * 160))
        except OSError:
            pass
        sock.close()
        self.listener.close()


def test_tcp_roundtrip():
    server = TcpMockServer()
    server.start()
    synth = MbeSynthesizer("127.0.0.1", server.port)
    synth.set_mode(TableMode(33))
    assert synth.channel_bytes() == 9
    assert synth.process(b"\x55" * 9) == 1
    deadline = time.time() + 5
    pcm = b""
    while len(pcm) < 320 and time.time() < deadline:
        pcm += synth.read_pcm()
        time.sleep(0.01)
    assert pcm == b"\x03\x04" * 160
    synth.close()


def test_tcp_has_ambe_check():
    """The --test connectivity path over TCP."""
    server = TcpMockServer()
    server.start()
    synth = MbeSynthesizer("127.0.0.1", server.port)
    assert synth.has_ambe_codec()
    synth.close()
