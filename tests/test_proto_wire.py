"""Cross-validate the hand-rolled codecserver protobuf codec against the
real protobuf implementation (protoc + google.protobuf).

The schema in tests/proto/codecserver.proto is reconstructed from the
field tables documented in digiham_jax/codec/proto.py (which follow
codecserver's proto/*.proto). Byte-equality against protobuf's
serializer validates the entire wire layer — varints, tags, packed
repeated enums, deterministic maps, nested messages, Any packing — so
the only remaining trust assumption is the field-number tables
themselves (one-line fixes if a codecserver version differs)."""
import shutil
import subprocess
import sys

import pytest

protoc = shutil.which("protoc")
pytestmark = pytest.mark.skipif(protoc is None, reason="protoc missing")


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    import os
    src = os.path.join(os.path.dirname(__file__), "proto")
    out = str(tmp_path_factory.mktemp("pb"))
    subprocess.run([protoc, f"-I{src}", f"--python_out={out}",
                    "codecserver.proto"], check=True)
    sys.path.insert(0, out)
    try:
        import codecserver_pb2
        yield codecserver_pb2
    finally:
        sys.path.remove(out)


def test_handshake_bytes(pb):
    from digiham_jax.codec import proto as p
    ours = p.Handshake("codecserver 0.2", "1.0").serialize()
    theirs = pb.Handshake(serverVersion="codecserver 0.2",
                          protocolVersion="1.0").SerializeToString()
    assert ours == theirs
    back = p.Handshake.parse(theirs)
    assert back.server_version == "codecserver 0.2"


def test_request_with_settings_bytes(pb):
    from digiham_jax.codec import proto as p
    ours = p.Request("ambe", p.Settings(
        directions=[p.DIRECTION_DECODE],
        args={"index": "33", "ratep": "0130:0763"})).serialize()
    msg = pb.Request(codec="ambe")
    msg.settings.directions.append(pb.DECODE)
    msg.settings.args["index"] = "33"
    msg.settings.args["ratep"] = "0130:0763"
    theirs = msg.SerializeToString(deterministic=True)
    assert ours == theirs
    back = p.Request.parse(theirs)
    assert back.settings.args == {"index": "33", "ratep": "0130:0763"}
    assert back.settings.directions == [p.DIRECTION_DECODE]


def test_response_framing_bytes(pb):
    from digiham_jax.codec import proto as p
    ours = p.Response(p.STATUS_OK, framing=p.FramingHint(9, 320))
    msg = pb.Response(result=pb.Response.OK,
                      framing=pb.FramingHint(channelBytes=9,
                                             audioBytes=320))
    assert ours.serialize() == msg.SerializeToString()
    back = p.Response.parse(msg.SerializeToString())
    assert (back.framing.channel_bytes, back.framing.audio_bytes) == (9, 320)


def test_data_and_check_bytes(pb):
    from digiham_jax.codec import proto as p
    payload = bytes(range(9))
    assert (p.ChannelData(payload).serialize()
            == pb.ChannelData(data=payload).SerializeToString())
    assert (p.SpeechData(b"\x01\x02").serialize()
            == pb.SpeechData(data=b"\x01\x02").SerializeToString())
    assert (p.Check("ambe").serialize()
            == pb.Check(codec="ambe").SerializeToString())
    ren = p.Renegotiation(p.Settings(args={"index": "34"}))
    msg = pb.Renegotiation()
    msg.settings.directions.append(pb.DECODE)
    # our Renegotiation defaults carry directions too; align explicitly
    ren.settings.directions = [p.DIRECTION_DECODE]
    msg.settings.args["index"] = "34"
    assert ren.serialize() == msg.SerializeToString(deterministic=True)


def test_any_packing_bytes(pb):
    from google.protobuf import any_pb2

    from digiham_jax.codec import proto as p
    ours = p.pack_any(p.Check("ambe"))
    a = any_pb2.Any()
    a.Pack(pb.Check(codec="ambe"))
    assert a.type_url == "type.googleapis.com/CodecServer.proto.Check"
    assert ours == a.SerializeToString()
    # framing: protobuf's delimited write == our frame_message
    from google.protobuf.internal.encoder import _VarintBytes
    framed = _VarintBytes(len(ours)) + ours
    assert p.frame_message(p.Check("ambe")) == framed
    # and our parser unpacks protobuf's bytes
    back = p.unpack_any(a.SerializeToString())
    assert isinstance(back, p.Check) and back.codec == "ambe"
