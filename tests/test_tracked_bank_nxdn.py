"""NXDN tracked bank equivalence vs the symbol-domain decoder."""
import numpy as np
import pytest

from digiham_jax.pipeline import NxdnPipeline
from digiham_jax.protocols.nxdn import make_decoder
from digiham_jax.protocols.nxdn.components import (
    MESSAGE_TYPE_IDLE,
    MESSAGE_TYPE_TX_RELEASE,
)
from digiham_jax.runtime.meta import PipelineMetaWriter
from digiham_jax.runtime.tracked_bank import NxdnAdapter, TrackedChannelBank

from nxdn_synth import (
    encode_facch1,
    encode_sacch_unit,
    nxdn_frame,
    vcall_superframe_bytes,
    voice_slot_dibits,
)


def make_streams(seed, n_channels=2):
    rng = np.random.default_rng(seed)
    streams = []
    for c in range(n_channels):
        units = vcall_superframe_bytes(int(rng.integers(0, 8)),
                                       int(rng.integers(1, 1 << 16)),
                                       int(rng.integers(1, 1 << 16)))
        payload = rng.integers(0, 4, 72).astype(np.uint8)
        parts = [rng.integers(0, 4, int(rng.integers(30, 250)))]
        for i in range(int(rng.integers(4, 9))):
            option = int(rng.integers(0, 4))
            slots = []
            for s in range(2):
                if (option >> (1 - s)) & 1:
                    slots.append(voice_slot_dibits(payload, 38 + 72 * s))
                else:
                    mt = (MESSAGE_TYPE_TX_RELEASE
                          if rng.random() < 0.15 else MESSAGE_TYPE_IDLE)
                    slots.append(encode_facch1(mt, 38 + 72 * s))
            lich = (0b01, 0b10, option)
            if rng.random() < 0.15:
                # RCCH / UDCH frames: SACCH + slots are skipped
                lich = (0b00, 0b10, option) if rng.random() < 0.5 \
                    else (0b01, 0b01, option)
            parts.append(nxdn_frame(
                lich, encode_sacch_unit(i % 4, units[i % 4]), slots))
        parts.append(np.zeros(300, np.uint8))
        dibits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
        if rng.random() < 0.5:
            idx = rng.random(len(dibits)) < 0.01
            dibits = dibits.copy()
            dibits[idx] = rng.integers(0, 4, int(idx.sum()))
        streams.append(dibits)
    n = min(len(s) for s in streams)
    return np.stack([s[:n] for s in streams])


def reference_path(streams):
    outs, metas = [], []
    for c in range(streams.shape[0]):
        dec = make_decoder()
        events = []
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        outs.append(dec.process(streams[c]))
        metas.append("".join(events))
    return outs, metas


def tracked_path(streams, chunk=768):
    C = streams.shape[0]
    pipe = NxdnPipeline(channels=C, sps=20, n_centuries=3)
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        pipe, adapter=NxdnAdapter(),
        on_output=lambda c, d: outputs.__setitem__(c, outputs[c] + d))
    metas = []
    for c in range(C):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    for lo in range(0, streams.shape[1], chunk):
        bank.push_dibits(streams[:, lo:lo + chunk])
    return outputs, ["".join(ev) for ev in metas]


@pytest.mark.parametrize("seed", range(6))
def test_exact_equivalence(seed):
    streams = make_streams(seed)
    outputs, metas = tracked_path(streams)
    ref_out, ref_meta = reference_path(streams)
    for c in range(streams.shape[0]):
        assert outputs[c] == ref_out[c], f"ch{c} payload diverges"
        assert metas[c] == ref_meta[c], f"ch{c} metadata diverges"


def test_noise_equivalence():
    rng = np.random.default_rng(17)
    streams = rng.integers(0, 4, (2, 12000)).astype(np.uint8)
    outputs, metas = tracked_path(streams, chunk=997)
    ref_out, ref_meta = reference_path(streams)
    for c in range(2):
        assert outputs[c] == ref_out[c]
        assert metas[c] == ref_meta[c]
