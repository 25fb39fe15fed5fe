"""TrackedChannelBank snapshot/restore: resuming mid-transmission must be
byte- and event-identical to an uninterrupted run (device carries, sample
backlog, dibit buffers, hunt/tracker/meta state all round-trip)."""
import numpy as np
import pytest

from digiham_jax.pipeline import DmrPipeline, FskPipeline
from digiham_jax.runtime.meta import PipelineMetaWriter
from digiham_jax.runtime.tracked_bank import (
    DstarAdapter,
    TrackedChannelBank,
)

from dmr_synth import voice_frame
from test_dstar import full_voice_stream

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def run_bank(make_bank, samples, chunk, snapshot_at=None):
    bank = make_bank()
    outputs = {c: b"" for c in range(samples.shape[0])}
    bank.on_output = lambda c, d: outputs.__setitem__(c, outputs[c] + d)
    metas = []
    for c in range(samples.shape[0]):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    for i, lo in enumerate(range(0, samples.shape[1], chunk)):
        if snapshot_at is not None and i == snapshot_at:
            blob = bank.snapshot()
            bank = make_bank()  # brand-new bank (fresh jit state)
            bank.on_output = lambda c, d: outputs.__setitem__(
                c, outputs[c] + d)
            for c in range(samples.shape[0]):
                bank.set_meta_writer(c, PipelineMetaWriter(
                    lambda b, ev=metas[c]: ev.append(b.decode())))
            bank.restore(blob)
        bank.push(samples[:, lo:lo + chunk])
    return outputs, ["".join(ev) for ev in metas]


def test_dmr_resume_mid_transmission():
    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(24)]
    dibits = np.concatenate([np.zeros(40, np.uint8)] + frames)
    sig = (np.repeat(LEVELS[dibits], 10) * 1000).astype(np.float32)
    samples = np.stack([sig, sig * 0.7])

    def make_bank():
        return TrackedChannelBank(
            DmrPipeline(channels=2, sps=10, n_centuries=2))

    base, base_meta = run_bank(make_bank, samples, 4096)
    # snapshot right in the middle of the voice stream
    res, res_meta = run_bank(make_bank, samples, 4096, snapshot_at=4)
    for c in range(2):
        assert len(base[c]) > 0
        assert res[c] == base[c], f"ch{c} payload differs after resume"
        assert res_meta[c] == base_meta[c], f"ch{c} metadata differs"


def test_dstar_resume_mid_header():
    """Snapshot while the hunt is position-locked on a pending header."""
    parts = full_voice_stream(25) + [np.zeros(300, np.uint8)]
    bits = np.concatenate(parts).astype(np.uint8)
    levels = np.array([-1.0, 1.0], np.float32)
    sig = (np.repeat(levels[bits], 10) * 1000).astype(np.float32)
    samples = np.stack([sig, sig])

    def make_bank():
        return TrackedChannelBank(
            FskPipeline(channels=2, protocol="dstar", n_centuries=2),
            adapter=DstarAdapter())

    base, base_meta = run_bank(make_bank, samples, 2048)
    for at in (1, 3, 6):
        res, res_meta = run_bank(make_bank, samples, 2048, snapshot_at=at)
        for c in range(2):
            assert res[c] == base[c], f"snapshot@{at} ch{c} differs"
            assert res_meta[c] == base_meta[c]
    assert len(base[0]) >= 9 * 20


def test_snapshot_is_plain_bytes():
    bank = TrackedChannelBank(
        DmrPipeline(channels=1, sps=10, n_centuries=2))
    blob = bank.snapshot()
    assert isinstance(blob, bytes) and len(blob) > 0
    bank2 = TrackedChannelBank(
        DmrPipeline(channels=1, sps=10, n_centuries=2))
    bank2.restore(blob)
    assert len(bank2.chans) == 1


def test_symbol_channel_bank_resume():
    """The symbol-domain ChannelBank snapshots/restores bit-exactly too
    (decoder phase machines + device carries + backlog)."""
    from digiham_jax.protocols.dmr import make_decoder
    from digiham_jax.runtime.channel_bank import ChannelBank

    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(24)]
    dibits = np.concatenate([np.zeros(40, np.uint8)] + frames)
    sig = (np.repeat(LEVELS[dibits], 10) * 1000).astype(np.float32)
    samples = np.stack([sig, sig * 0.7])
    chunk = 4096

    def run(snapshot_at=None):
        out = {0: b"", 1: b""}
        bank = ChannelBank(
            DmrPipeline(channels=2, sps=10, n_centuries=2),
            [make_decoder() for _ in range(2)],
            on_output=lambda c, d: out.__setitem__(c, out[c] + d))
        for i, lo in enumerate(range(0, samples.shape[1], chunk)):
            if snapshot_at is not None and i == snapshot_at:
                blob = bank.snapshot()
                bank = ChannelBank(
                    DmrPipeline(channels=2, sps=10, n_centuries=2),
                    [make_decoder() for _ in range(2)],
                    on_output=lambda c, d: out.__setitem__(
                        c, out[c] + d))
                bank.restore(blob)
            bank.push(samples[:, lo:lo + chunk])
        return out

    base = run()
    res = run(snapshot_at=4)
    for c in range(2):
        assert len(base[c]) > 0
        assert res[c] == base[c]
