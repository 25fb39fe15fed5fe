"""DSP front-end tests: block kernels vs per-symbol/per-sample host oracles."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.dsp import (
    WIDE_RRC,
    NARROW_RRC,
    RrcState,
    rrc_filter,
    DemodState,
    demod_init,
    fsk_demod_block,
    gfsk_demod_block,
    FskDemodNp,
    GfskDemodNp,
    DigitalVoiceState,
    digitalvoice_filter,
    DigitalVoiceFilterNp,
    fm_discriminator,
    dc_block,
    DcBlockState,
)
from digiham_jax.dsp.rrc import rrc_filter_np


def synth_4fsk(symbols, sps, amp=1000.0, noise=0.0, seed=0):
    """Shaped 4FSK baseband: dibit -> level {1:+3, 0:+1, 2:-1, 3:-3}."""
    levels = np.array([1.0, 3.0, -1.0, -3.0])
    sig = np.repeat(levels[np.asarray(symbols)], sps) * amp / 3
    if noise:
        rng = np.random.default_rng(seed)
        sig = sig + rng.normal(0, noise * amp, sig.shape)
    return sig.astype(np.float32)


def synth_2fsk(bits, sps, amp=1000.0):
    levels = np.array([-1.0, 1.0])
    return (np.repeat(levels[np.asarray(bits)], sps) * amp).astype(np.float32)


class TestRrc:
    @pytest.mark.parametrize("design", [WIDE_RRC, NARROW_RRC])
    def test_matches_oracle(self, design):
        rng = np.random.default_rng(1)
        x = rng.normal(0, 1, 400).astype(np.float32)
        want = rrc_filter_np(x, design)
        state = RrcState.init(1, design)
        got, _ = rrc_filter(jnp.asarray(x)[None, :], state, design)
        np.testing.assert_allclose(np.asarray(got)[0], want, atol=1e-5)

    def test_block_size_invariance(self):
        """Same output regardless of how the stream is blocked."""
        rng = np.random.default_rng(2)
        x = rng.normal(0, 1, 600).astype(np.float32)
        state = RrcState.init(1, WIDE_RRC)
        full, _ = rrc_filter(jnp.asarray(x)[None, :], state, WIDE_RRC)
        state = RrcState.init(1, WIDE_RRC)
        parts = []
        for lo in range(0, 600, 150):
            y, state = rrc_filter(jnp.asarray(x[lo:lo + 150])[None, :],
                                  state, WIDE_RRC)
            parts.append(np.asarray(y)[0])
        np.testing.assert_allclose(
            np.concatenate(parts), np.asarray(full)[0], atol=1e-6)

    def test_batched_channels(self):
        rng = np.random.default_rng(3)
        x = rng.normal(0, 1, (4, 300)).astype(np.float32)
        state = RrcState.init(4, WIDE_RRC)
        got, _ = rrc_filter(jnp.asarray(x), state, WIDE_RRC)
        for c in range(4):
            np.testing.assert_allclose(
                np.asarray(got)[c], rrc_filter_np(x[c]), atol=1e-5)


class TestDemod:
    @pytest.mark.parametrize("sps", [10, 20])
    def test_gfsk_matches_oracle(self, sps):
        rng = np.random.default_rng(4)
        n_sym = 350
        tx = rng.integers(0, 4, n_sym + 10)
        sig = synth_4fsk(tx, sps, noise=0.05)
        oracle = GfskDemodNp(sps, precision="f32")
        want = oracle.process(sig)

        n_cent = 3
        need = n_cent * 100 * sps + n_cent + 2
        state = demod_init(1)
        got, state = gfsk_demod_block(
            jnp.asarray(sig[:need])[None, :], state, n_cent, sps)
        got = np.asarray(got)[0]
        np.testing.assert_array_equal(got, want[:n_cent * 100])

    def test_gfsk_timing_slew(self):
        """A fractional symbol offset must engage the ±1 slew and still
        match the oracle (exercises the variance feedback path)."""
        sps = 10
        rng = np.random.default_rng(5)
        tx = rng.integers(0, 4, 450)
        sig = synth_4fsk(tx, sps, noise=0.02)
        sig = sig[3:]  # start mid-symbol: timing must recover
        oracle = GfskDemodNp(sps, precision="f32")
        want = oracle.process(sig)
        state = demod_init(1)
        got, state = gfsk_demod_block(
            jnp.asarray(sig[:4 * 1000 + 10])[None, :], state, 4, sps)
        got = np.asarray(got)[0]
        np.testing.assert_array_equal(got, want[:400])
        # at least one slew must have happened for a misaligned signal
        assert oracle.pos != 400 * sps or np.asarray(state.pos)[0] != 400 * sps

    @pytest.mark.parametrize("invert", [False, True])
    def test_fsk_matches_oracle(self, invert):
        sps = 40
        rng = np.random.default_rng(6)
        tx = rng.integers(0, 2, 250)
        sig = synth_2fsk(tx, sps)
        oracle = FskDemodNp(sps, invert=invert, precision="f32")
        want = oracle.process(sig)
        state = demod_init(1)
        n_cent = 2
        got, _ = fsk_demod_block(
            jnp.asarray(sig[:n_cent * 100 * sps + 10])[None, :],
            state, n_cent, sps, invert)
        np.testing.assert_array_equal(np.asarray(got)[0], want[:200])

    def test_block_continuity(self):
        """Two 2-century blocks == one 4-century block (carry correctness)."""
        sps = 10
        rng = np.random.default_rng(7)
        tx = rng.integers(0, 4, 450)
        sig = synth_4fsk(tx, sps, noise=0.1)[3:]
        full_state = demod_init(1)
        full, _ = gfsk_demod_block(
            jnp.asarray(sig[:4100])[None, :], full_state, 4, sps)

        state = demod_init(1)
        a, state = gfsk_demod_block(
            jnp.asarray(sig[:4100])[None, :], state, 2, sps)
        b, state = gfsk_demod_block(
            jnp.asarray(sig[:4100])[None, :], state, 2, sps)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(a)[0], np.asarray(b)[0]]),
            np.asarray(full)[0])

    def test_decodes_clean_4fsk(self):
        sps = 10
        tx = np.random.default_rng(8).integers(0, 4, 220)
        sig = synth_4fsk(tx, sps)
        state = demod_init(1)
        got, _ = gfsk_demod_block(
            jnp.asarray(sig[:2010])[None, :], state, 2, sps)
        # after AGC settles (first ~100 symbols), symbols must match tx
        got = np.asarray(got)[0]
        np.testing.assert_array_equal(got[100:200], tx[100:200])


class TestDigitalVoice:
    def test_matches_oracle(self):
        rng = np.random.default_rng(9)
        pcm = (rng.normal(0, 3000, 500)).astype(np.int16)
        want = DigitalVoiceFilterNp().process(pcm)
        state = DigitalVoiceState.init(1)
        got, _ = digitalvoice_filter(jnp.asarray(pcm)[None, :], state)
        np.testing.assert_allclose(np.asarray(got)[0], want, atol=2)

    def test_stream_continuity(self):
        rng = np.random.default_rng(10)
        pcm = (rng.normal(0, 3000, 400)).astype(np.int16)
        state = DigitalVoiceState.init(1)
        full, _ = digitalvoice_filter(jnp.asarray(pcm)[None, :], state)
        state = DigitalVoiceState.init(1)
        parts = []
        for lo in range(0, 400, 100):
            y, state = digitalvoice_filter(
                jnp.asarray(pcm[lo:lo + 100])[None, :], state)
            parts.append(np.asarray(y)[0])
        np.testing.assert_allclose(
            np.concatenate(parts), np.asarray(full)[0], atol=1)

    def test_passband_gain(self):
        """1 kHz tone passes, 60 Hz hum is strongly attenuated."""
        t = np.arange(4000) / 8000.0
        tone = (np.sin(2 * np.pi * 1000 * t) * 8000).astype(np.int16)
        hum = (np.sin(2 * np.pi * 60 * t) * 8000).astype(np.int16)
        state = DigitalVoiceState.init(2)
        out, _ = digitalvoice_filter(jnp.asarray(np.stack([tone, hum])), state)
        out = np.asarray(out).astype(np.float64)
        assert np.abs(out[0, 2000:]).max() > 3000
        assert np.abs(out[1, 2000:]).max() < 500


class TestFmFrontend:
    def test_discriminator_recovers_tone(self):
        fs, f_dev = 48000.0, 3000.0
        t = np.arange(2000) / fs
        msg = np.sin(2 * np.pi * 400 * t)
        phase = 2 * np.pi * f_dev * np.cumsum(msg) / fs
        iq = np.exp(1j * phase).astype(np.complex64)
        audio, _ = fm_discriminator(
            jnp.asarray(iq)[None, :], jnp.ones((1,), jnp.complex64))
        audio = np.asarray(audio)[0]
        expect = 2 * f_dev / fs * msg
        np.testing.assert_allclose(audio[1:], expect[1:], atol=1e-3)

    def test_dc_block_removes_offset(self):
        x = (np.ones(4000) * 0.5).astype(np.float32)
        y, _ = dc_block(jnp.asarray(x)[None, :], DcBlockState.init(1))
        assert abs(np.asarray(y)[0, -1]) < 1e-2

    def test_dc_block_continuity(self):
        rng = np.random.default_rng(11)
        x = rng.normal(0, 1, (1, 600)).astype(np.float32)
        full, _ = dc_block(jnp.asarray(x), DcBlockState.init(1))
        state = DcBlockState.init(1)
        parts = []
        for lo in range(0, 600, 200):
            y, state = dc_block(jnp.asarray(x[:, lo:lo + 200]), state)
            parts.append(np.asarray(y))
        np.testing.assert_allclose(
            np.concatenate(parts, axis=1), np.asarray(full), atol=1e-4)
