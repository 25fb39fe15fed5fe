"""End-of-stream flush: a finite recording with NO trailing padding must
decode byte-identically to the reference chain (whose demod lookahead is
one symbol, vs the bank's ~2 centuries). flush() drains the buffered
tail via the reference-exact per-symbol oracle seeded from the device
carry."""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

HARNESS_DIR = os.path.join(os.path.dirname(__file__), "ref_harness")


def _ours_tracked(pipe, adapter, samples, chunk=4096):
    from digiham_jax.runtime.meta import PipelineMetaWriter
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank

    out = {0: b""}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: out.__setitem__(0, out[0] + d),
        adapter=adapter)
    events = []
    bank.set_meta_writer(0, PipelineMetaWriter(
        lambda b: events.append(b.decode("utf-8", "surrogateescape"))))
    row = samples[None, :].astype(np.float32)
    for lo in range(0, row.shape[1], chunk):
        bank.push(row[:, lo:lo + chunk])
    bank.flush()
    return bank, out[0], "".join(events)


def _reference(demod_args, protocol, samples, tmp_path):
    from tools.fuzz_fullchain import DSP, REF
    p1 = subprocess.run(
        [os.path.join(HARNESS_DIR, "dsp_harness")] + demod_args,
        input=samples.astype(np.float32).tobytes(), capture_output=True)
    meta = str(tmp_path / "meta.txt")
    p2 = subprocess.run([os.path.join(HARNESS_DIR, "ref_harness"),
                         protocol, meta], input=p1.stdout,
                        capture_output=True)
    with open(meta, encoding="utf-8", errors="surrogateescape") as f:
        return p2.stdout, f.read()


def test_dstar_abrupt_end(tmp_path, ref_harness):
    from digiham_jax.pipeline import FskPipeline
    from digiham_jax.runtime.tracked_bank import DstarAdapter
    from test_dstar import full_voice_stream
    rng = np.random.default_rng(7)
    bits = np.concatenate(full_voice_stream(25))
    lv = np.array([-1.0, 1.0])
    samples = (np.repeat(lv[bits.astype(int)], 10) * 900
               + rng.normal(0, 90, len(bits) * 10)).astype(np.float32)
    bank, got, meta = _ours_tracked(
        FskPipeline(channels=1, protocol="dstar", n_centuries=2),
        DstarAdapter(), samples)
    ref, ref_meta = _reference(["fsk", "10"], "dstar", samples, tmp_path)
    assert got == ref and meta == ref_meta and len(ref) > 0
    with pytest.raises(Exception):
        bank.push(np.zeros((1, 100), np.float32))  # terminal


def _pocsag_abrupt():
    """A POCSAG message whose stream ends with no trailing padding;
    returns (samples, the bank's flushed output)."""
    from digiham_jax.pipeline import FskPipeline
    from digiham_jax.runtime.tracked_bank import PocsagAdapter
    from test_pocsag import (address_codeword, alpha_payloads,
                             build_stream, data_codeword)
    rng = np.random.default_rng(8)
    cws = [address_codeword(99887, 3)]
    cws += [data_codeword(p) for p in alpha_payloads("FLUSH WORKS")]
    bits = build_stream(cws)
    lv = np.array([1.0, -1.0])
    samples = (np.repeat(lv[bits.astype(int)], 40) * 1100
               + rng.normal(0, 120, len(bits) * 40)).astype(np.float32)
    _, got, _ = _ours_tracked(
        FskPipeline(channels=1, protocol="pocsag", n_centuries=2),
        PocsagAdapter(), samples, chunk=8192)
    return samples, got


def test_pocsag_abrupt_end_decodes():
    """flush() drains the tail: the whole message comes out."""
    _, got = _pocsag_abrupt()
    assert b"FLUSH WORKS" in got


def test_pocsag_abrupt_end(tmp_path, ref_harness):
    samples, got = _pocsag_abrupt()
    ref, _ = _reference(["fsk", "40", "i"], "pocsag", samples, tmp_path)
    assert got == ref and b"FLUSH WORKS" in got


def test_symbol_channel_bank_flush(tmp_path):
    """ChannelBank.flush with the full per-channel decoders."""
    from digiham_jax.pipeline import FskPipeline
    from digiham_jax.protocols.dstar import make_decoder
    from digiham_jax.runtime.channel_bank import ChannelBank
    from test_dstar import full_voice_stream
    bits = np.concatenate(full_voice_stream(20))
    lv = np.array([-1.0, 1.0])
    samples = np.stack(
        [(np.repeat(lv[bits.astype(int)], 10) * 1000)
         .astype(np.float32)] * 2)
    out = {0: b"", 1: b""}
    bank = ChannelBank(
        FskPipeline(channels=2, protocol="dstar", n_centuries=2),
        [make_decoder() for _ in range(2)],
        on_output=lambda c, d: out.__setitem__(c, out[c] + d))
    for lo in range(0, samples.shape[1], 4096):
        bank.push(samples[:, lo:lo + 4096])
    bank.flush()
    # exact contract: == one-shot decode of the oracle-demodulated
    # FULL stream (the final frame stays in the DECODER's own 120-bit
    # lookahead, faithfully — the demod tail is fully drained)
    from digiham_jax.dsp.demod import FskDemodNp
    all_bits = FskDemodNp(10).process(samples[0])
    want = make_decoder().process(all_bits)
    assert out[0] == want and out[1] == want and len(want) > 0


def test_subclassed_pipeline_flush_parity():
    """_flush_demod must dispatch on the pipeline's rrc_design ATTRIBUTE,
    not its class name: a subclassed (renamed) DmrPipeline flushes its
    tail byte-identically to the plain one. Under the old
    type(...).__name__ dispatch the subclass silently skipped the RRC
    stage on the flushed tail (round-4 VERDICT weak #8)."""
    from digiham_jax.pipeline import DmrPipeline
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank
    from dmr_synth import voice_frame

    class RenamedDmrPipeline(DmrPipeline):
        pass

    levels = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
    payload = np.tile([2, 0, 3, 1], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(9)]
    dibits = np.concatenate([np.zeros(40, np.uint8)] + frames)
    rng = np.random.default_rng(11)
    sig = (np.repeat(levels[dibits], 10) * 1000
           + rng.normal(0, 60, len(dibits) * 10)).astype(np.float32)
    # abrupt end mid-frame: the last frames live in the buffered tail
    # and only reach the decoder through _flush_demod
    row = sig[None, :]

    def run(cls):
        out = [b""]
        bank = TrackedChannelBank(
            cls(channels=1, sps=10, n_centuries=2),
            on_output=lambda c, d: out.__setitem__(0, out[0] + d))
        for lo in range(0, row.shape[1], 4096):
            bank.push(row[:, lo:lo + 4096])
        bank.flush()
        return out[0]

    base, sub = run(DmrPipeline), run(RenamedDmrPipeline)
    assert len(base) > 0
    assert sub == base


def test_cli_demod_flush_matches_reference_binary(tmp_path, ref_harness):
    """The fsk_demodulator CLI drains its tail at EOF: byte-identical
    symbol stream to the reference binary on UNPADDED input."""
    from test_dstar import full_voice_stream
    bits = np.concatenate(full_voice_stream(10))
    lv = np.array([-1.0, 1.0])
    rng = np.random.default_rng(5)
    x = (np.repeat(lv[bits.astype(int)], 10) * 800
         + rng.normal(0, 80, len(bits) * 10)).astype(np.float32)
    ref = subprocess.run(
        [os.path.join(HARNESS_DIR, "dsp_harness"), "fsk", "10"],
        input=x.tobytes(), capture_output=True).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ours = subprocess.run(["fsk_demodulator", "-s", "10"],
                          input=x.tobytes(), capture_output=True,
                          env=env, timeout=500).stdout
    assert ours == ref and len(ref) > 1500
