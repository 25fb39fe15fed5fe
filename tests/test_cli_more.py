"""Additional CLI coverage: remaining decoder tools + the MBE synthesizer
CLI against a unix-socket mock codecserver."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_cli import run_tool
from test_codec_socket import UnixMockServer


class TestYsfCli:
    def test_decodes_stream(self, tmp_path):
        from ysf_synth import terminator_frame, vd2_frame
        frames = [vd2_frame(i, b"CLIYSF    ") for i in range(3)]
        frames.append(terminator_frame())
        frames.append(terminator_frame())
        dibits = np.concatenate(frames).astype(np.uint8)
        meta = str(tmp_path / "m.txt")
        out = run_tool("ysf_decoder_main", ["-f", meta], dibits.tobytes())
        assert len(out) >= 3 * 5 * 8
        content = open(meta).read()
        assert "protocol:YSF" in content and "mode:DN" in content


class TestNxdnCli:
    def test_decodes_stream(self, tmp_path):
        from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                                vcall_superframe_bytes, voice_slot_dibits)
        units = vcall_superframe_bytes(0b001, 99, 88)
        payload = (np.arange(72) % 4).astype(np.uint8)
        frames = [nxdn_frame((0b01, 0b10, 0b11),
                             encode_sacch_unit(i, units[i]),
                             [voice_slot_dibits(payload, 38),
                              voice_slot_dibits(payload, 110)])
                  for i in range(4)]
        dibits = np.concatenate(
            frames + [np.zeros(200, np.uint8)]).astype(np.uint8)
        meta = str(tmp_path / "m.txt")
        out = run_tool("nxdn_decoder_main", ["-f", meta], dibits.tobytes())
        assert len(out) >= 3 * 2 * 18
        content = open(meta).read()
        assert "protocol:NXDN" in content and "source:99" in content


class TestDstarCli:
    def test_decodes_stream(self, tmp_path):
        from test_dstar import full_voice_stream
        bits = np.concatenate(
            full_voice_stream(24) + [np.zeros(250, np.uint8)]
        ).astype(np.uint8)
        meta = str(tmp_path / "m.txt")
        out = run_tool("dstar_decoder_main", ["-f", meta], bits.tobytes())
        assert len(out) >= 9 * 15
        content = open(meta).read()
        assert "protocol:DSTAR" in content and "ourcall:W1AW/705" in content


class TestMbeCli:
    def test_test_flag_against_mock(self):
        path = os.path.join(tempfile.mkdtemp(), "cs.sock")
        server = UnixMockServer(path)
        server.start()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        code = ("from digiham_jax.cli.tools import mbe_synthesizer_main;"
                "import sys; sys.argv=['mbe_synthesizer','-s',"
                f"{path!r},'-t'];"
                "raise SystemExit(mbe_synthesizer_main())")
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, timeout=60, env=env)
        assert proc.returncode == 0, proc.stderr.decode()[-500:]
        assert b"server response ok" in proc.stderr
