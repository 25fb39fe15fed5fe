"""YSF tracked bank equivalence vs the symbol-domain decoder."""
import numpy as np
import pytest

from digiham_jax.pipeline import YsfPipeline
from digiham_jax.protocols.ysf import make_decoder
from digiham_jax.runtime.meta import PipelineMetaWriter
from digiham_jax.runtime.tracked_bank import TrackedChannelBank, YsfAdapter

from ysf_synth import (header_frame, terminator_frame, v1_frame,
                       vd2_frame, vw_frame)


def make_streams(seed, n_channels=2):
    rng = np.random.default_rng(seed)
    streams = []
    for c in range(n_channels):
        parts = [rng.integers(0, 4, int(rng.integers(30, 300)))]
        parts.append(header_frame(b"DEST", b"SRC", b"DOWN", b"UP"))
        for _ in range(int(rng.integers(3, 8))):
            kind = rng.integers(0, 3)
            fn = int(rng.integers(0, 8))
            if kind == 0:
                parts.append(vd2_frame(fn, b"TRACKYSF  "))
            elif kind == 1:
                parts.append(v1_frame(fn, rng.integers(0, 4, 36)))
            else:
                parts.append(vw_frame(
                    fn, rng.integers(0, 256, 18).astype(np.uint8)
                    .tobytes()))
        parts.append(terminator_frame())
        parts.append(rng.integers(0, 4, 100))
        for _ in range(int(rng.integers(2, 5))):
            parts.append(vd2_frame(int(rng.integers(0, 8)),
                                   b"SECONDTX  "))
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


def tracked_path(streams, chunk=960):
    C = streams.shape[0]
    pipe = YsfPipeline(channels=C, sps=10, n_centuries=5)
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        pipe, adapter=YsfAdapter(),
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
    rng = np.random.default_rng(7)
    streams = rng.integers(0, 4, (2, 15000)).astype(np.uint8)
    outputs, metas = tracked_path(streams, chunk=1111)
    ref_out, ref_meta = reference_path(streams)
    for c in range(2):
        assert outputs[c] == ref_out[c]
        assert metas[c] == ref_meta[c]
