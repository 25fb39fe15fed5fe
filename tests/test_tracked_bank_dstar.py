"""TrackedChannelBank D-Star adapter: byte- and event-identical to the
per-channel symbol-domain Decoder (hunt incl. 660-bit header decode,
96-bit voice frames with 24-bit terminator lookahead)."""
import numpy as np
import pytest

from digiham_jax.pipeline import FskPipeline
from digiham_jax.protocols.dstar import make_decoder
from digiham_jax.protocols.dstar.phases import TERMINATOR, VOICE_SYNC
from digiham_jax.runtime.meta import PipelineMetaWriter
from digiham_jax.runtime.tracked_bank import DstarAdapter, TrackedChannelBank

from test_dstar import (
    bit_sync_preamble,
    full_voice_stream,
    voice_frame,
)


def make_streams(seed, n_channels=3):
    rng = np.random.default_rng(seed)
    streams = []
    for c in range(n_channels):
        parts = [rng.integers(0, 2, int(rng.integers(50, 400)))]
        for _ in range(2):
            kind = rng.integers(0, 3)
            if kind == 0:
                parts += full_voice_stream(int(rng.integers(5, 45)))
            elif kind == 1:
                # voice-sync entry without a header
                parts += [bit_sync_preamble(), VOICE_SYNC]
                parts += [voice_frame(raw_data24=VOICE_SYNC)
                          if i % 21 == 20 else voice_frame()
                          for i in range(int(rng.integers(5, 30)))]
            else:
                parts += full_voice_stream(int(rng.integers(3, 10)))
                term = np.concatenate([
                    np.unpackbits(np.frombuffer(b"\xAA" * 9, np.uint8),
                                  bitorder="little"), TERMINATOR])
                parts.append(term)
            parts.append(rng.integers(0, 2, int(rng.integers(30, 200))))
        dibits = np.concatenate(
            [np.asarray(p, np.uint8) for p in parts])
        if rng.random() < 0.5:
            idx = rng.random(len(dibits)) < 0.005
            dibits = dibits.copy()
            dibits[idx] ^= 1
        streams.append(dibits)
    n = min(len(s) for s in streams)
    return np.stack([s[:n] for s in streams])


def reference_path(streams, chunk=700):
    outs, metas = [], []
    for c in range(streams.shape[0]):
        dec = make_decoder()
        events = []
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        buf = b""
        for lo in range(0, streams.shape[1], chunk):
            buf += dec.process(streams[c][lo:lo + chunk])
        outs.append(buf)
        metas.append("".join(events))
    return outs, metas


def tracked_path(streams, chunk=700, gated=False):
    C = streams.shape[0]
    pipe = FskPipeline(channels=C, protocol="dstar", n_centuries=2)
    adapter = DstarAdapter()
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d), adapter=adapter)
    metas = []
    for c in range(C):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    for lo in range(0, streams.shape[1], chunk):
        blk = streams[:, lo:lo + chunk].astype(np.uint8)
        if gated and blk.shape[1] > 32:
            from digiham_jax.pipeline.fsk import bit_sync_correlate
            from digiham_jax.protocols.dstar.phases import HEADER_SYNC
            import jax.numpy as jnp
            b = jnp.asarray(blk)
            hits = adapter.block_hits({
                "sync_dist_header_sync":
                    bit_sync_correlate(b, HEADER_SYNC),
                "sync_dist_voice_sync":
                    bit_sync_correlate(b, VOICE_SYNC),
            })
            bank._consume_dibits(blk, hits)
        else:
            bank.push_dibits(blk)
    return outputs, ["".join(ev) for ev in metas]


@pytest.mark.parametrize("seed", range(6))
def test_exact_equivalence(seed):
    streams = make_streams(seed)
    outputs, metas = tracked_path(streams)
    ref_out, ref_meta = reference_path(streams)
    for c in range(streams.shape[0]):
        assert outputs[c] == ref_out[c], f"ch{c} payload diverges"
        assert metas[c] == ref_meta[c], f"ch{c} metadata diverges"


@pytest.mark.parametrize("seed", range(3))
def test_equivalence_with_device_gated_hunting(seed):
    streams = make_streams(seed)
    outputs, metas = tracked_path(streams, gated=True)
    ref_out, ref_meta = reference_path(streams)
    for c in range(streams.shape[0]):
        assert outputs[c] == ref_out[c], f"ch{c} payload diverges"
        assert metas[c] == ref_meta[c], f"ch{c} metadata diverges"


def test_noise_equivalence():
    rng = np.random.default_rng(7)
    streams = rng.integers(0, 2, (2, 20000)).astype(np.uint8)
    outputs, metas = tracked_path(streams, chunk=977)
    ref_out, ref_meta = reference_path(streams, chunk=977)
    for c in range(2):
        assert outputs[c] == ref_out[c]
        assert metas[c] == ref_meta[c]


def test_full_sample_path_smoke():
    """Samples -> 2FSK demod -> tracked bank end to end."""
    parts = full_voice_stream(30) + [np.zeros(300, np.uint8)]
    bits = np.concatenate(parts)
    levels = np.array([-1.0, 1.0], np.float32)
    samples = np.stack(
        [np.repeat(levels[bits], 10) * 1000] * 2).astype(np.float32)
    pipe = FskPipeline(channels=2, protocol="dstar", n_centuries=2)
    outputs = {c: b"" for c in range(2)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d), adapter=DstarAdapter())
    for lo in range(0, samples.shape[1], 4096):
        bank.push(samples[:, lo:lo + 4096])
    for c in range(2):
        assert len(outputs[c]) >= 9 * 20
        assert outputs[c][:9] == b"\xAA" * 9


def test_half_terminator_equivalence():
    """Half-length terminator (24 data bits only, dstar_phase.cpp:96-100)
    through the tracked bank."""
    from digiham_jax.protocols.dstar.phases import TERMINATOR
    parts = full_voice_stream(6)
    half_term = np.concatenate([
        np.unpackbits(np.frombuffer(b"\x55" * 9, np.uint8),
                      bitorder="little"),
        TERMINATOR[24:],
    ])
    parts += [half_term, np.ones(300, np.uint8)]
    streams = np.stack([np.concatenate(parts).astype(np.uint8)] * 2)
    outputs, metas = tracked_path(streams, gated=True)
    ref_out, ref_meta = reference_path(streams)
    for c in range(2):
        assert outputs[c] == ref_out[c]
        assert metas[c] == ref_meta[c]
