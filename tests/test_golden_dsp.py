"""Golden DSP tests: the reference front-end modules (compiled C++) vs
digiham_jax's device kernels on identical sample streams. Validates the
AGC, symbol-timing variance loop, slicers, FIR, and IIR at the symbol /
sample level."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from digiham_jax.dsp.audio import DigitalVoiceState, digitalvoice_filter
from digiham_jax.dsp.demod import demod_init, fsk_demod_block, \
    gfsk_demod_block
from digiham_jax.dsp.rrc import NARROW_RRC, WIDE_RRC, RrcState, rrc_filter

HARNESS_DIR = os.path.join(os.path.dirname(__file__), "ref_harness")
HARNESS = os.path.join(HARNESS_DIR, "dsp_harness")

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


# only these tests run the reference binaries: skip, not error, when
# the reference source tree is absent (tests/conftest.py)
pytestmark = pytest.mark.usefixtures("ref_harness")


def ref(args, data, dtype_out):
    p = subprocess.run([HARNESS] + args, input=np.asarray(data).tobytes(),
                       capture_output=True, timeout=120)
    assert p.returncode == 0, p.stderr.decode()[-500:]
    return np.frombuffer(p.stdout, dtype_out)


class TestGfskGolden:
    @pytest.mark.parametrize("noise,offset", [
        (0.0, 0), (0.05, 0), (0.15, 0), (0.05, 3), (0.1, 7)])
    def test_symbol_exact(self, noise, offset):
        """Symbol decisions identical to the C demodulator, including the
        AGC window and +-1 timing slews, at up to 15% noise and with
        mid-symbol start offsets."""
        rng = np.random.default_rng(int(noise * 100) + offset)
        tx = rng.integers(0, 4, 1500)
        sig = (np.repeat(LEVELS[tx], 10) * 1000
               + rng.normal(0, noise * 1000, 15000)).astype(np.float32)
        sig = sig[offset:]
        want = ref(["gfsk", "10"], sig, np.uint8)
        n_cent = (len(sig) // 10 - 2) // 100
        got, _ = gfsk_demod_block(jnp.asarray(sig)[None, :],
                                  demod_init(1), n_cent, 10)
        got = np.asarray(got)[0]
        n = min(len(got), len(want))
        assert n >= n_cent * 100 - 1
        np.testing.assert_array_equal(got[:n], want[:n])

    def test_sps20(self):
        rng = np.random.default_rng(9)
        tx = rng.integers(0, 4, 700)
        sig = (np.repeat(LEVELS[tx], 20) * 800
               + rng.normal(0, 60, 14000)).astype(np.float32)
        want = ref(["gfsk", "20"], sig, np.uint8)
        n_cent = (len(sig) // 20 - 2) // 100
        got, _ = gfsk_demod_block(jnp.asarray(sig)[None, :],
                                  demod_init(1), n_cent, 20)
        got = np.asarray(got)[0]
        n = min(len(got), len(want))
        np.testing.assert_array_equal(got[:n], want[:n])


class TestFskGolden:
    @pytest.mark.parametrize("invert", [False, True])
    def test_bit_exact(self, invert):
        rng = np.random.default_rng(5 + invert)
        tx = rng.integers(0, 2, 500)
        sig = (np.repeat(np.array([-1.0, 1.0])[tx], 40) * 800
               + rng.normal(0, 80, 20000)).astype(np.float32)
        args = ["fsk", "40"] + (["i"] if invert else [])
        want = ref(args, sig, np.uint8)
        n_cent = (len(sig) // 40 - 2) // 100
        got, _ = fsk_demod_block(jnp.asarray(sig)[None, :],
                                 demod_init(1), n_cent, 40, invert)
        got = np.asarray(got)[0]
        n = min(len(got), len(want))
        np.testing.assert_array_equal(got[:n], want[:n])


class TestRrcGolden:
    @pytest.mark.parametrize("mode,design", [
        ("rrc", WIDE_RRC), ("rrc-narrow", NARROW_RRC)])
    def test_float_tolerance(self, mode, design):
        """f32 reassociation is the only divergence (conv vs serial MAC)."""
        rng = np.random.default_rng(2)
        x = rng.normal(0, 1000, 5000).astype(np.float32)
        want = ref([mode], x, np.float32)
        got, _ = rrc_filter(jnp.asarray(x)[None, :],
                            RrcState.init(1, design), design)
        got = np.asarray(got)[0][:len(want)]
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-5


class TestDigitalVoiceGolden:
    def test_one_lsb(self):
        rng = np.random.default_rng(3)
        pcm = rng.normal(0, 3000, 4000).astype(np.int16)
        want = ref(["dv"], pcm, np.int16)
        got, _ = digitalvoice_filter(jnp.asarray(pcm)[None, :],
                                     DigitalVoiceState.init(1))
        got = np.asarray(got)[0][:len(want)]
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1  # float rounding at the int16 boundary


class TestFullChainGolden:
    def test_rrc_gfsk_dmr_identical(self, tmp_path):
        """The reference's own shell pipeline (rrc_filter |
        gfsk_demodulator | dmr_decoder) vs our chain: identical voice
        payload bytes from the same baseband samples."""
        from dmr_synth import voice_frame
        from digiham_jax.protocols.dmr import make_decoder
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(10)]
        dibits = np.concatenate([np.zeros(40, np.uint8)] + frames)
        rng = np.random.default_rng(8)
        sig = (np.repeat(LEVELS[dibits], 10) * 1000
               + rng.normal(0, 30, len(dibits) * 10)).astype(np.float32)

        filtered_ref = ref(["rrc"], sig, np.float32)
        symbols_ref = ref(["gfsk", "10"],
                          filtered_ref.astype(np.float32), np.uint8)
        p = subprocess.run(
            [os.path.join(HARNESS_DIR, "ref_harness"), "dmr"],
            input=symbols_ref.tobytes(), capture_output=True, timeout=60)
        ref_payload = p.stdout

        filt, _ = rrc_filter(jnp.asarray(sig)[None, :],
                             RrcState.init(1, WIDE_RRC), WIDE_RRC)
        n_cent = (filt.shape[1] // 10 - 2) // 100
        syms, _ = gfsk_demod_block(filt, demod_init(1), n_cent, 10)
        our_payload = make_decoder().process(np.asarray(syms)[0])
        assert ref_payload == our_payload
        assert len(our_payload) >= 27
