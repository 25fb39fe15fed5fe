"""TrackedChannelBank POCSAG adapter: byte-identical to the symbol-domain
Decoder; the per-codeword host BCH moves to one batched device call."""
import numpy as np
import pytest

from digiham_jax.pipeline import FskPipeline
from digiham_jax.protocols import pocsag
from digiham_jax.runtime.tracked_bank import (
    PocsagAdapter,
    TrackedChannelBank,
)

from test_pocsag import (
    address_codeword,
    alpha_payloads,
    build_stream,
    data_codeword,
)


def numeric_payloads(digits: str):
    out = []
    bits = []
    for ch in digits:
        v = int(ch)
        bits.extend(((v >> (3 - k)) & 1) for k in range(4))
    while len(bits) % 20:
        bits.append(1)  # trailing reversed-BCD 0xF = '('
    for i in range(0, len(bits), 20):
        word = 0
        for j in range(20):
            word |= bits[i + j] << (19 - j)
        out.append(word)
    return out


def make_streams(seed, n_channels=3):
    rng = np.random.default_rng(seed)
    streams = []
    for c in range(n_channels):
        parts = [rng.integers(0, 2, int(rng.integers(40, 300)))]
        for _ in range(3):
            text = "".join(chr(65 + int(x))
                           for x in rng.integers(0, 26, 12))
            cws = [address_codeword(int(rng.integers(1, 1 << 18)), 3)]
            cws += [data_codeword(p) for p in alpha_payloads(text)]
            parts.append(build_stream(cws, preamble_bits=64))
            parts.append(rng.integers(0, 2, int(rng.integers(20, 150))))
        bits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
        if rng.random() < 0.5:
            idx = rng.random(len(bits)) < 0.003
            bits = bits.copy()
            bits[idx] ^= 1
        streams.append(bits)
    n = min(len(s) for s in streams)
    return np.stack([s[:n] for s in streams])


def reference_path(streams, chunk=501):
    outs = []
    for c in range(streams.shape[0]):
        dec = pocsag.make_decoder()
        buf = b""
        for lo in range(0, streams.shape[1], chunk):
            buf += dec.process(streams[c][lo:lo + chunk])
        outs.append(buf)
    return outs


def tracked_path(streams, chunk=501, gated=False):
    C = streams.shape[0]
    pipe = FskPipeline(channels=C, protocol="pocsag", n_centuries=2)
    adapter = PocsagAdapter()
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d), adapter=adapter)
    for lo in range(0, streams.shape[1], chunk):
        blk = streams[:, lo:lo + chunk].astype(np.uint8)
        if gated and blk.shape[1] > 32:
            from digiham_jax.pipeline.fsk import bit_sync_correlate
            import jax.numpy as jnp
            hits = adapter.block_hits({"sync_dist_preamble":
                bit_sync_correlate(jnp.asarray(blk),
                                   pocsag.SYNC_PATTERN)})
            bank._consume_dibits(blk, hits)
        else:
            bank.push_dibits(blk)
    return outputs


@pytest.mark.parametrize("seed", range(6))
def test_exact_equivalence(seed):
    streams = make_streams(seed)
    outputs = tracked_path(streams)
    ref = reference_path(streams)
    for c in range(streams.shape[0]):
        assert outputs[c] == ref[c], f"ch{c} diverges"
        assert b"message:" in outputs[c] or len(outputs[c]) == 0


@pytest.mark.parametrize("seed", range(3))
def test_equivalence_with_device_gated_hunting(seed):
    streams = make_streams(seed)
    outputs = tracked_path(streams, gated=True)
    ref = reference_path(streams)
    for c in range(streams.shape[0]):
        assert outputs[c] == ref[c], f"ch{c} diverges"


def test_numeric_messages():
    cws = [address_codeword(777, 1)]
    cws += [data_codeword(p) for p in numeric_payloads("0123456789")]
    bits = build_stream(cws)
    streams = np.stack([bits]).astype(np.uint8)
    outputs = tracked_path(streams)
    ref = reference_path(streams)
    assert outputs[0] == ref[0]


def test_noise_equivalence():
    rng = np.random.default_rng(11)
    streams = rng.integers(0, 2, (2, 24000)).astype(np.uint8)
    outputs = tracked_path(streams, chunk=977)
    ref = reference_path(streams, chunk=977)
    for c in range(2):
        assert outputs[c] == ref[c]


def test_full_sample_path_smoke():
    """Samples -> inverted 2FSK demod (40 sps) -> tracked bank."""
    cws = [address_codeword(4242, 3)]
    cws += [data_codeword(p) for p in alpha_payloads("FSK BANK")]
    bits = np.concatenate([build_stream(cws), np.zeros(200, np.uint8)])
    levels = np.array([1.0, -1.0], np.float32)  # inverted mapping
    samples = np.stack(
        [np.repeat(levels[bits], 40) * 1000] * 2).astype(np.float32)
    pipe = FskPipeline(channels=2, protocol="pocsag", n_centuries=2)
    outputs = {c: b"" for c in range(2)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d), adapter=PocsagAdapter())
    for lo in range(0, samples.shape[1], 8192):
        bank.push(samples[:, lo:lo + 8192])
    for c in range(2):
        assert b"message:FSK BANK" in outputs[c]


@pytest.mark.parametrize("sps", [20, 40, 94])
def test_other_baud_rates(sps):
    """512/2400 baud = different sps (the reference's --samples flag):
    the tracked sample path decodes at any symbol rate."""
    cws = [address_codeword(55, 3)]
    cws += [data_codeword(p) for p in alpha_payloads("RATE TEST")]
    bits = np.concatenate([build_stream(cws), np.zeros(200, np.uint8)])
    levels = np.array([1.0, -1.0], np.float32)
    samples = np.stack(
        [(np.repeat(levels[bits], sps) * 1000).astype(np.float32)] * 2)
    pipe = FskPipeline(channels=2, protocol="pocsag", n_centuries=2,
                       sps=sps)
    outputs = {c: b"" for c in range(2)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d), adapter=PocsagAdapter())
    for lo in range(0, samples.shape[1], 8192):
        bank.push(samples[:, lo:lo + 8192])
    for c in range(2):
        assert b"message:RATE TEST" in outputs[c]
