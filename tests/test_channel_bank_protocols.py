"""ChannelBank with the YSF / NXDN / 2FSK pipelines."""
import numpy as np
import pytest

from digiham_jax.pipeline import FskPipeline, NxdnPipeline, YsfPipeline
from digiham_jax.runtime.channel_bank import ChannelBank
from digiham_jax.runtime.meta import PipelineMetaWriter

from ysf_synth import vd2_frame, terminator_frame
from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                        vcall_superframe_bytes, voice_slot_dibits)
from test_pocsag import (IDLE_CODEWORD, address_codeword, alpha_payloads,
                         build_stream, data_codeword)

LEVELS4 = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def synth4(dibits, sps, amp=1000.0):
    return (np.repeat(LEVELS4[np.asarray(dibits)], sps) * amp
            ).astype(np.float32)


def synth2(bits, sps, amp=1000.0, invert=False):
    lv = np.array([1.0, -1.0]) if invert else np.array([-1.0, 1.0])
    return (np.repeat(lv[np.asarray(bits)], sps) * amp).astype(np.float32)


def test_ysf_bank():
    from digiham_jax.protocols.ysf import make_decoder
    channels = 2
    frames = [vd2_frame(i, b"BANKTEST  ") for i in range(4)]
    frames.append(terminator_frame())
    dibits = np.concatenate([np.zeros(60, np.uint8)] + frames)
    sig = synth4(dibits, 10)
    samples = np.stack([sig, sig])
    events = []
    pipe = YsfPipeline(channels=channels, sps=10, n_centuries=5)
    bank = ChannelBank(pipe, [make_decoder() for _ in range(channels)])
    for c, dec in enumerate(bank.decoders):
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b, c=c: events.append((c, b.decode()))))
    for lo in range(0, samples.shape[1], 8192):
        bank.push(samples[:, lo:lo + 8192])
    assert {c for c, e in events if "mode:DN" in e} == {0, 1}


def test_nxdn_bank():
    from digiham_jax.protocols.nxdn import make_decoder
    channels = 2
    units = vcall_superframe_bytes(0b001, 555, 666)
    payload = (np.arange(72) % 4).astype(np.uint8)
    frames = [nxdn_frame((0b01, 0b10, 0b11),
                         encode_sacch_unit(i, units[i]),
                         [voice_slot_dibits(payload, 38),
                          voice_slot_dibits(payload, 110)])
              for i in range(4)]
    dibits = np.concatenate(
        [np.zeros(50, np.uint8)] + frames + [np.zeros(250, np.uint8)])
    sig = synth4(dibits, 20)
    samples = np.stack([sig, sig])
    events = []
    outputs = {0: b"", 1: b""}
    pipe = NxdnPipeline(channels=channels, sps=20, n_centuries=3)
    bank = ChannelBank(pipe, [make_decoder() for _ in range(channels)],
                       on_output=lambda c, d: outputs.__setitem__(
                           c, outputs[c] + d))
    for c, dec in enumerate(bank.decoders):
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b, c=c: events.append((c, b.decode()))))
    for lo in range(0, samples.shape[1], 8192):
        bank.push(samples[:, lo:lo + 8192])
    assert len(outputs[0]) >= 2 * 18
    assert any("source:555" in e for _, e in events)


def test_pocsag_bank():
    from digiham_jax.protocols.pocsag import make_decoder
    channels = 2
    texts = ["BANK A", "BANK B"]
    sigs = []
    for t in texts:
        cws = [address_codeword(42, 3)]
        cws.extend(data_codeword(p) for p in alpha_payloads(t))
        cws.append(IDLE_CODEWORD)
        bits = build_stream(cws)
        sigs.append(synth2(bits, 40, invert=True))
    m = min(len(s) for s in sigs)
    samples = np.stack([s[:m] for s in sigs])
    outputs = {0: b"", 1: b""}
    pipe = FskPipeline(channels=channels, protocol="pocsag", n_centuries=3)
    bank = ChannelBank(pipe, [make_decoder() for _ in range(channels)],
                       on_output=lambda c, d: outputs.__setitem__(
                           c, outputs[c] + d))
    for lo in range(0, samples.shape[1], 16384):
        bank.push(samples[:, lo:lo + 16384])
    assert b"BANK A" in outputs[0]
    assert b"BANK B" in outputs[1]
