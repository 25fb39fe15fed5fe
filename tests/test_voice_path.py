"""Full voice path integration: protocol decoder output -> MbeSynthesizer
(dynamic mode, mock codecserver) -> PCM -> digitalvoice filter."""
import time

import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.codec import DynamicMode, MbeSynthesizer, TableMode
from digiham_jax.codec.modes import ysf_mode_for
from digiham_jax.dsp.audio import DigitalVoiceState, digitalvoice_filter
from test_codec import MockCodecServer

from ysf_synth import terminator_frame, vd2_frame
from dmr_synth import voice_frame


def wait_pcm(synth, nbytes, timeout=5.0):
    deadline = time.time() + timeout
    pcm = b""
    while len(pcm) < nbytes and time.time() < deadline:
        pcm += synth.read_pcm()
        time.sleep(0.005)
    return pcm


class TestYsfVoicePath:
    def test_dn_stream_to_pcm(self):
        """YSF DN frames -> mode-byte-prefixed AMBE -> renegotiation to
        table 34 -> PCM out."""
        from digiham_jax.protocols.ysf import make_decoder
        frames = [vd2_frame(i, b"VOICEPATH ") for i in range(3)]
        frames.append(terminator_frame())
        stream = np.concatenate(frames)
        voice_bytes = make_decoder().process(stream)
        assert len(voice_bytes) == 3 * 5 * 8  # mode byte + 7 AMBE x5 x3

        server = MockCodecServer()
        server.start()
        synth = MbeSynthesizer(server.client_sock)
        synth.set_mode(DynamicMode(ysf_mode_for))
        shipped = synth.process(voice_bytes)
        assert shipped == 15
        # DN mode negotiated from the in-stream mode bytes
        assert synth.channel_bytes() == 7
        assert server.renegotiations == [{"index": "34"}]
        pcm = wait_pcm(synth, 15 * 14)
        assert len(pcm) == 15 * 14  # mock echoes 2x the 7 channel bytes
        synth.close()

    def test_pcm_through_audio_filter(self):
        """PCM tail of the chain: digitalvoice bandpass on synthesized
        speech-band audio."""
        t = np.arange(1600) / 8000.0
        pcm = (np.sin(2 * np.pi * 800 * t) * 8000).astype(np.int16)
        out, _ = digitalvoice_filter(jnp.asarray(pcm)[None, :],
                                     DigitalVoiceState.init(1))
        out = np.asarray(out)[0]
        assert np.abs(out[800:]).max() > 2000  # passband signal survives


class TestDmrVoicePath:
    def test_dmr_frames_to_pcm(self):
        """DMR voice payload (27B/frame = 3 AMBE frames of 9B) -> table 33
        codec -> PCM."""
        from digiham_jax.protocols.dmr import make_decoder
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(6)]
        voice_bytes = make_decoder().process(np.concatenate(frames))
        assert len(voice_bytes) % 27 == 0 and voice_bytes

        server = MockCodecServer()
        server.start()
        synth = MbeSynthesizer(server.client_sock)
        synth.set_mode(TableMode(33))
        assert synth.channel_bytes() == 9
        shipped = synth.process(voice_bytes)
        assert shipped == len(voice_bytes) // 9
        pcm = wait_pcm(synth, shipped * 18)
        assert len(pcm) == shipped * 18
        synth.close()


class TestTrackedBankVoicePath:
    def test_samples_to_pcm_production_topology(self):
        """The full production chain: RF samples -> TrackedChannelBank
        (device pipeline + batched field decode) -> voice bytes ->
        MbeSynthesizer (table 33) -> PCM -> digitalvoice filter."""
        from digiham_jax.pipeline import DmrPipeline
        from digiham_jax.runtime.tracked_bank import TrackedChannelBank

        levels = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True)
                  for s in range(16)]
        # the demod (2 centuries) and framer (1-frame lookahead) hold a
        # tail of ~3 frames until more samples arrive — push 16 to get 8+
        dibits = np.concatenate([np.zeros(30, np.uint8)] + frames)
        samples = np.stack(
            [(np.repeat(levels[dibits], 10) * 1000).astype(np.float32)] * 2)

        server = MockCodecServer()
        server.start()
        synth = MbeSynthesizer(server.client_sock)
        synth.set_mode(TableMode(33))
        shipped = [0]
        pipe = DmrPipeline(channels=2, sps=10, n_centuries=2)
        bank = TrackedChannelBank(
            pipe, on_output=lambda c, d: shipped.__setitem__(
                0, shipped[0] + (synth.process(d) if c == 0 else 0)))
        for lo in range(0, samples.shape[1], 4096):
            bank.push(samples[:, lo:lo + 4096])
        assert shipped[0] >= 8 * 3  # >=8 bursts x 3 AMBE frames
        pcm = wait_pcm(synth, shipped[0] * 18)
        assert len(pcm) == shipped[0] * 18
        out, _ = digitalvoice_filter(
            jnp.asarray(np.frombuffer(pcm, np.int16))[None, :],
            DigitalVoiceState.init(1))
        assert np.asarray(out).shape[1] == len(pcm) // 2
        synth.close()
