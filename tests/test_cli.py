"""CLI tool tests: drive the pipe-composable tools through real
stdin/stdout subprocesses, like the reference's shell pipelines."""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_pocsag import (
    IDLE_CODEWORD,
    address_codeword,
    alpha_payloads,
    build_stream,
    data_codeword,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(main_name: str, args: list, stdin: bytes,
             timeout=240) -> bytes:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    code = (f"import jax; jax.config.update('jax_platforms','cpu');"
            f"from digiham_jax.cli.tools import {main_name};"
            f"import sys; sys.argv=['x']+{args!r};"
            f"raise SystemExit({main_name}())")
    proc = subprocess.run(
        [sys.executable, "-c", code], input=stdin,
        capture_output=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    return proc.stdout


class TestPocsagCli:
    def test_decodes_message(self):
        text = "CLI TEST"
        cws = [address_codeword(500, 3)]
        cws.extend(data_codeword(p) for p in alpha_payloads(text))
        cws.append(IDLE_CODEWORD)
        bits = build_stream(cws).astype(np.uint8)
        out = run_tool("pocsag_decoder_main", [], bits.tobytes())
        assert f"message:{text}".encode() in out


class TestRrcFilterCli:
    def test_filters_stream(self):
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, 2000).astype(np.float32)
        out = run_tool("rrc_filter_main", [], x.tobytes())
        y = np.frombuffer(out, np.float32)
        assert len(y) == len(x)
        from digiham_jax.dsp.rrc import rrc_filter_np
        np.testing.assert_allclose(y, rrc_filter_np(x), atol=1e-5)

    def test_narrow_flag(self):
        x = np.zeros(500, np.float32)
        x[0] = 1.0
        out = run_tool("rrc_filter_main", ["--narrow"], x.tobytes())
        y = np.frombuffer(out, np.float32)
        from digiham_jax.dsp.rrc import NARROW_RRC
        # impulse response peak = center tap / gain
        peak = max(NARROW_RRC.taps) / NARROW_RRC.gain
        np.testing.assert_allclose(y.max(), peak, rtol=1e-5)


class TestMetadataFifo:
    def test_dmr_decoder_meta_file(self, tmp_path):
        """-f writes the out-of-band metadata stream (reference
        DecoderCli contract, src/lib/cli.cpp:117-141)."""
        from dmr_synth import data_frame, group_lc
        lc = group_lc(2300042, 2623317)
        frames = [data_frame(s % 2, 1, lc) for s in range(6)]
        dibits = np.concatenate(frames).astype(np.uint8)
        meta = str(tmp_path / "meta.txt")
        out = run_tool("dmr_decoder_main", ["-f", meta], dibits.tobytes())
        content = open(meta).read()
        assert "protocol:DMR" in content
        assert "source:2623317" in content and "target:2300042" in content


class TestDmrPipelineCli:
    def test_gfsk_into_dmr(self):
        """gfsk_demodulator | dmr_decoder — two-stage shell pipeline."""
        from dmr_synth import voice_frame
        from digiham_jax.protocols.dmr.phases import pack_dibits
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(8)]
        dibits = np.concatenate(frames)
        # synthesize 4FSK baseband at 10 sps
        levels = np.array([1.0, 3.0, -1.0, -3.0]) * 1000 / 3
        sig = np.repeat(levels[dibits], 10).astype(np.float32)
        sym = run_tool("gfsk_demodulator_main", ["-s", "10"], sig.tobytes())
        out = run_tool("dmr_decoder_main", [], sym)
        assert len(out) >= 27
        assert pack_dibits(payload) in out

class TestBackendEquivalence:
    """--backend numpy (default, oracle fast path) vs --backend jax
    (device century pipeline) on identical streams."""

    def test_gfsk_backends_bit_exact(self):
        rng = np.random.default_rng(7)
        levels = np.array([1.0, 3.0, -1.0, -3.0]) * 1000 / 3
        dib = rng.integers(0, 4, 600)
        sig = (np.repeat(levels[dib], 10)
               + rng.normal(0, 60, 6000)).astype(np.float32)
        a = run_tool("gfsk_demodulator_main", ["-s", "10"], sig.tobytes())
        b = run_tool("gfsk_demodulator_main",
                     ["-s", "10", "--backend", "jax"], sig.tobytes())
        assert a == b and len(a) > 500

    def test_rrc_backends_within_f32_envelope(self):
        rng = np.random.default_rng(8)
        x = rng.normal(0, 1000, 4000).astype(np.float32)
        a = np.frombuffer(
            run_tool("rrc_filter_main", [], x.tobytes()), np.float32)
        b = np.frombuffer(
            run_tool("rrc_filter_main", ["--backend", "jax"], x.tobytes()),
            np.float32)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-2)


class TestDigitalVoiceCli:
    def test_bandpass_backends(self):
        rng = np.random.default_rng(9)
        pcm = (rng.normal(0, 3000, 1600)).astype(np.int16)
        a = np.frombuffer(
            run_tool("digitalvoice_filter_main", [], pcm.tobytes()),
            np.int16)
        b = np.frombuffer(
            run_tool("digitalvoice_filter_main", ["--backend", "jax"],
                     pcm.tobytes()), np.int16)
        assert len(a) == len(pcm)
        np.testing.assert_allclose(a, b, atol=2)
