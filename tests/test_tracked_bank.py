"""TrackedChannelBank equivalence: the device-fields tracking path must be
byte- and event-identical to the per-channel symbol-domain Decoder on the
same dibit streams."""
import numpy as np
import pytest

from digiham_jax.pipeline import DmrPipeline
from digiham_jax.protocols.dmr import make_decoder
from digiham_jax.runtime.meta import PipelineMetaWriter
from digiham_jax.runtime.tracked_bank import TrackedChannelBank

from dmr_synth import data_frame, group_lc, voice_frame, voice_superframe

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def make_streams(seed, n_channels=3):
    rng = np.random.default_rng(seed)
    streams = []
    for c in range(n_channels):
        lc = group_lc(int(rng.integers(1, 1 << 24)),
                      int(rng.integers(1, 1 << 24)))
        payload = rng.integers(0, 4, 108)
        parts = [rng.integers(0, 4, int(rng.integers(50, 400)))]
        for _ in range(3):
            kind = rng.integers(0, 3)
            if kind == 0:
                parts += [voice_frame(s % 2, payload, sync=True)
                          for s in range(int(rng.integers(3, 9)))]
            elif kind == 1:
                parts += [data_frame(s % 2, int(rng.integers(0, 11)), lc)
                          for s in range(4)]
            else:
                parts += voice_superframe(int(rng.integers(0, 2)), lc,
                                          payload)
        dibits = np.concatenate([p.astype(np.uint8) for p in parts])
        if rng.random() < 0.5:
            idx = rng.random(len(dibits)) < 0.01
            dibits = dibits.copy()
            dibits[idx] = rng.integers(0, 4, int(idx.sum()))
        streams.append(dibits)
    n = min(len(s) for s in streams)
    return np.stack([s[:n] for s in streams])


def reference_path(dibit_streams, chunk=None):
    outs, metas = [], []
    for c in range(dibit_streams.shape[0]):
        dec = make_decoder()
        events = []
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        if chunk is None:
            outs.append(dec.process(dibit_streams[c]))
        else:
            buf = b""
            for lo in range(0, dibit_streams.shape[1], chunk):
                buf += dec.process(dibit_streams[c][lo:lo + chunk])
            outs.append(buf)
        metas.append("".join(events))
    return outs, metas


def tracked_path_dibits(dibit_streams, chunk=800):
    C = dibit_streams.shape[0]
    pipe = DmrPipeline(channels=C, sps=10, n_centuries=2)
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d))
    metas = []
    for c in range(C):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    for lo in range(0, dibit_streams.shape[1], chunk):
        bank.push_dibits(dibit_streams[:, lo:lo + chunk])
    return outputs, ["".join(ev) for ev in metas]


@pytest.mark.parametrize("seed", range(8))
def test_exact_equivalence_on_dibits(seed):
    streams = make_streams(seed)
    outputs, metas = tracked_path_dibits(streams)
    ref_out, ref_meta = reference_path(streams)
    for c in range(streams.shape[0]):
        assert outputs[c] == ref_out[c], f"ch{c} payload diverges"
        assert metas[c] == ref_meta[c], f"ch{c} metadata diverges"


def test_noise_equivalence():
    rng = np.random.default_rng(99)
    streams = rng.integers(0, 4, (2, 12000)).astype(np.uint8)
    outputs, metas = tracked_path_dibits(streams, chunk=977)
    ref_out, ref_meta = reference_path(streams)
    for c in range(2):
        assert outputs[c] == ref_out[c]
        assert metas[c] == ref_meta[c]


def test_full_sample_path_smoke():
    """Samples -> demod -> tracked bank end to end (clean signal)."""
    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(12)]
    dibits = np.concatenate([np.zeros(30, np.uint8)] + frames)
    samples = np.stack(
        [(np.repeat(LEVELS[dibits], 10) * 1000).astype(np.float32)] * 4)
    pipe = DmrPipeline(channels=4, sps=10, n_centuries=2)
    outputs = {c: b"" for c in range(4)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d))
    for lo in range(0, samples.shape[1], 8192):
        bank.push(samples[:, lo:lo + 8192])
    from digiham_jax.protocols.dmr.phases import pack_dibits
    for c in range(4):
        assert pack_dibits(payload) in outputs[c]


@pytest.mark.parametrize("seed", range(6))
def test_equivalence_with_device_gated_hunting(seed):
    """The device-gated fast hunt path (_fast_skip) must not change any
    output: feed block_hits computed from the dense correlation."""
    from digiham_jax.pipeline.dmr import dmr_sync_correlate
    import jax.numpy as jnp

    streams = make_streams(seed)
    C = streams.shape[0]
    pipe = DmrPipeline(channels=C, sps=10, n_centuries=2)
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d))
    metas = []
    for c in range(C):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    chunk = 800
    for lo in range(0, streams.shape[1], chunk):
        blk = streams[:, lo:lo + chunk]
        if blk.shape[1] > 24:
            dist = np.asarray(dmr_sync_correlate(jnp.asarray(blk)))
            hits = (dist <= 3).any(axis=(1, 2))
        else:
            hits = np.ones(C, bool)
        bank._consume_dibits(blk.astype(np.uint8), hits)
    ref_out, ref_meta = reference_path(streams)
    for c in range(C):
        assert outputs[c] == ref_out[c], f"ch{c} payload diverges"
        assert "".join(metas[c]) == ref_meta[c], f"ch{c} metadata diverges"


def test_gated_noise_equivalence():
    from digiham_jax.pipeline.dmr import dmr_sync_correlate
    import jax.numpy as jnp

    rng = np.random.default_rng(123)
    streams = rng.integers(0, 4, (2, 16000)).astype(np.uint8)
    pipe = DmrPipeline(channels=2, sps=10, n_centuries=2)
    outputs = {0: b"", 1: b""}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d))
    metas = []
    for c in range(2):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    for lo in range(0, streams.shape[1], 977):
        blk = streams[:, lo:lo + 977]
        if blk.shape[1] > 24:
            dist = np.asarray(dmr_sync_correlate(jnp.asarray(blk)))
            hits = (dist <= 3).any(axis=(1, 2))
        else:
            hits = np.ones(2, bool)
        bank._consume_dibits(blk.astype(np.uint8), hits)
    ref_out, ref_meta = reference_path(streams)
    for c in range(2):
        assert outputs[c] == ref_out[c]
        assert "".join(metas[c]) == ref_meta[c]
