"""Full-chain tests: baseband synthesis -> (RRC) -> demod -> decoder for
every protocol, mirroring the reference's examples/*.sh pipelines."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.dsp.demod import demod_init, fsk_demod_block, \
    gfsk_demod_block
from digiham_jax.dsp.rrc import NARROW_RRC, WIDE_RRC, RrcState, rrc_filter
from digiham_jax.runtime.meta import PipelineMetaWriter

from dmr_synth import voice_frame as dmr_voice_frame
from nxdn_synth import nxdn_frame, encode_sacch_unit, vcall_superframe_bytes, \
    voice_slot_dibits
from ysf_synth import vd2_frame, terminator_frame
from test_pocsag import (address_codeword, alpha_payloads, build_stream,
                         data_codeword, IDLE_CODEWORD)
from test_dstar import full_voice_stream as dstar_stream

LEVELS_4FSK = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def synth_4fsk(dibits, sps, amp=1000.0):
    return (np.repeat(LEVELS_4FSK[np.asarray(dibits)], sps)
            * amp).astype(np.float32)


def synth_2fsk(bits, sps, amp=1000.0, invert=False):
    lv = np.array([-1.0, 1.0]) if not invert else np.array([1.0, -1.0])
    return (np.repeat(lv[np.asarray(bits)], sps) * amp).astype(np.float32)


def demod_gfsk(sig, sps, use_rrc=None):
    sig = jnp.asarray(sig)[None, :]
    if use_rrc is not None:
        sig, _ = rrc_filter(sig, RrcState.init(1, use_rrc), use_rrc)
    n_cent = (sig.shape[1] // sps - 2) // 100
    dibits, _ = gfsk_demod_block(sig, demod_init(1), n_cent, sps)
    return np.asarray(dibits)[0]


def demod_fsk(sig, sps, invert=False):
    sig = jnp.asarray(sig)[None, :]
    n_cent = (sig.shape[1] // sps - 2) // 100
    bits, _ = fsk_demod_block(sig, demod_init(1), n_cent, sps, invert)
    return np.asarray(bits)[0]


def events_of(dec):
    ev = []
    dec.set_meta_writer(PipelineMetaWriter(lambda b: ev.append(b.decode())))
    return ev


class TestYsfChain:
    def test_wide_rrc_gfsk_ysf(self):
        """examples/ysf-decoder.sh: rrc_filter | gfsk_demodulator |
        ysf_decoder."""
        from digiham_jax.protocols.ysf import make_decoder
        frames = [vd2_frame(i, b"CHAINTEST ") for i in range(3)]
        frames.append(terminator_frame())
        dibits = np.concatenate(
            [np.zeros(120, np.uint8)] + frames)
        sig = synth_4fsk(dibits, 10)
        rx = demod_gfsk(sig, 10, use_rrc=WIDE_RRC)
        dec = make_decoder()
        ev = events_of(dec)
        out = dec.process(rx)
        assert len(out) >= 2 * 5 * 8
        assert any("mode:DN" in e for e in ev)


class TestNxdnChain:
    def test_narrow_rrc_gfsk_nxdn(self):
        """examples/nxdn48-decoder.sh: rrc_filter -n | gfsk_demodulator
        -s 20 | nxdn_decoder."""
        from digiham_jax.protocols.nxdn import make_decoder
        units = vcall_superframe_bytes(0b001, 777, 888)
        payload = (np.arange(72) % 4).astype(np.uint8)
        frames = []
        for i in range(4):
            frames.append(nxdn_frame(
                (0b01, 0b10, 0b11),
                encode_sacch_unit(i, units[i]),
                [voice_slot_dibits(payload, 38),
                 voice_slot_dibits(payload, 110)]))
        dibits = np.concatenate(
            [np.zeros(60, np.uint8)] + frames + [np.zeros(250, np.uint8)])
        sig = synth_4fsk(dibits, 20)
        rx = demod_gfsk(sig, 20, use_rrc=NARROW_RRC)
        dec = make_decoder()
        ev = events_of(dec)
        out = dec.process(rx)
        assert len(out) >= 3 * 2 * 18
        assert any("source:777" in e and "destination:888" in e for e in ev)


class TestDstarChain:
    def test_fsk_dstar(self):
        """examples/dstar-decoder.sh: fsk_demodulator -s 10 |
        dstar_decoder (no RRC)."""
        from digiham_jax.protocols.dstar import make_decoder
        import test_dstar
        bits = np.concatenate(
            dstar_stream(24) + [np.zeros(300, np.uint8)])
        sig = synth_2fsk(bits, 10)
        rx = demod_fsk(sig, 10)
        dec = make_decoder()
        ev = events_of(dec)
        out = dec.process(rx)
        assert len(out) >= 9 * 15
        assert any("ourcall:W1AW/705" in e for e in ev)


class TestPocsagChain:
    def test_inverted_fsk_pocsag(self):
        """examples/pocsag-decoder.sh: fsk_demodulator -i -s 40 |
        pocsag_decoder."""
        from digiham_jax.protocols.pocsag import make_decoder
        text = "RF CHAIN"
        cws = [address_codeword(321, 3)]
        cws.extend(data_codeword(p) for p in alpha_payloads(text))
        cws.append(IDLE_CODEWORD)
        bits = build_stream(cws)
        sig = synth_2fsk(bits, 40, invert=True)
        rx = demod_fsk(sig, 40, invert=True)
        out = make_decoder().process(rx).decode()
        assert f"message:{text}" in out
