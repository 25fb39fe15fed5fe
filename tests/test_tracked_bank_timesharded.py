"""Time-sharded TrackedChannelBank: the production tracker bank driven
by the (channel, time) streaming carry-chain pipeline must emit bytes
and metadata events identical to the unsharded bank on the same sample
stream — including snapshot/restore and the EOF flush tail."""
import numpy as np
import pytest

import jax

from digiham_jax.parallel import make_mesh
from digiham_jax.parallel.streaming import TimeShardedPipeline
from digiham_jax.pipeline import DmrPipeline
from digiham_jax.runtime.meta import PipelineMetaWriter
from digiham_jax.runtime.tracked_bank import (
    TimeShardedTrackedBank,
    TrackedChannelBank,
)

from dmr_synth import voice_frame

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
C = 2


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return make_mesh(n_channel_shards=2, n_time_shards=2)


def _sharded_bank(mesh, cps=36, drift_budget=None):
    sp = TimeShardedPipeline(mesh, channels=C, protocol="dmr",
                             centuries_per_shard=cps,
                             drift_budget=drift_budget)
    outputs = {c: b"" for c in range(C)}
    bank = TimeShardedTrackedBank(
        sp, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d))
    metas = []
    for c in range(C):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    return bank, outputs, metas


def _plain_bank():
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        DmrPipeline(channels=C, sps=10, n_centuries=4),
        on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d))
    metas = []
    for c in range(C):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    return bank, outputs, metas


def _samples(seed, n_frames=120, noise=40.0):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 4, 108)
    frames = [voice_frame(s % 2, payload, sync=True)
              for s in range(n_frames)]
    dibits = np.concatenate([np.zeros(30, np.uint8)] + frames)
    base = np.repeat(LEVELS[dibits], 10) * 1000
    return np.stack([base + rng.normal(0, noise, base.shape)
                     for _ in range(C)]).astype(np.float32)


def test_timesharded_bank_equals_unsharded(mesh):
    samples = _samples(3)
    bank_s, out_s, meta_s = _sharded_bank(mesh)
    bank_p, out_p, meta_p = _plain_bank()
    for lo in range(0, samples.shape[1], 8192):
        bank_s.push(samples[:, lo:lo + 8192])
        bank_p.push(samples[:, lo:lo + 8192])
    # the stream must be long enough that the device path actually
    # stepped (not everything through the flush oracle)
    assert samples.shape[1] > bank_s.pipeline.block_len + 2000
    assert any(len(v) > 0 for v in out_s.values())
    bank_s.flush()
    bank_p.flush()
    for c in range(C):
        assert out_s[c] == out_p[c], f"ch{c} payload diverges"
        assert "".join(meta_s[c]) == "".join(meta_p[c]), \
            f"ch{c} metadata diverges"
    assert any(len(v) > 0 for v in out_p.values())  # decoded something


def test_timesharded_bank_snapshot_restore(mesh):
    samples = _samples(9, n_frames=130)
    half = (samples.shape[1] // 2) // 512 * 512
    bank, outputs, metas = _sharded_bank(mesh)
    bank.push(samples[:, :half])
    blob = bank.snapshot()

    bank2, outputs2, metas2 = _sharded_bank(mesh)
    bank2.restore(blob)
    pre = {c: len(outputs[c]) for c in outputs}
    bank.push(samples[:, half:])
    bank2.push(samples[:, half:])
    for c in outputs:
        assert outputs[c][pre[c]:] == outputs2[c]


def test_timesharded_bank_dstar_equals_unsharded(mesh):
    """The 2FSK bit-domain path (no RRC) with the lookahead-carrying
    D-Star adapter: header hunt + voice tracking byte/event parity."""
    from digiham_jax.pipeline import FskPipeline
    from digiham_jax.runtime.tracked_bank import DstarAdapter

    from test_dstar import full_voice_stream

    rng = np.random.default_rng(5)
    parts = (full_voice_stream(140)
             + [np.zeros(400, np.uint8)])
    bits = np.concatenate(parts)
    levels = np.array([-1.0, 1.0], np.float32)
    base = np.repeat(levels[bits], 10) * 1000
    samples = np.stack([base + rng.normal(0, 60, base.shape)
                        for _ in range(C)]).astype(np.float32)

    results = {}
    for sharded in (False, True):
        outputs = {c: b"" for c in range(C)}
        if sharded:
            sp = TimeShardedPipeline(mesh, channels=C, protocol="dstar",
                                     centuries_per_shard=16)
            bank = TimeShardedTrackedBank(
                sp, adapter=DstarAdapter(),
                on_output=lambda c, d: outputs.__setitem__(
                    c, outputs[c] + d))
            assert samples.shape[1] > sp.block_len + 2000
        else:
            bank = TrackedChannelBank(
                FskPipeline(channels=C, protocol="dstar", n_centuries=2),
                adapter=DstarAdapter(),
                on_output=lambda c, d: outputs.__setitem__(
                    c, outputs[c] + d))
        metas = []
        for c in range(C):
            events = []
            bank.set_meta_writer(c, PipelineMetaWriter(
                lambda b, ev=events: ev.append(b.decode())))
            metas.append(events)
        for lo in range(0, samples.shape[1], 8192):
            bank.push(samples[:, lo:lo + 8192])
        bank.flush()
        results[sharded] = (dict(outputs),
                            ["".join(e) for e in metas])
    assert results[True] == results[False]
    assert any(len(v) > 0 for v in results[False][0].values())


def test_timesharded_bank_flush_only_tail(mesh):
    """A stream shorter than one sharded block decodes entirely via the
    EOF flush oracle — parity with the unsharded bank's flush."""
    samples = _samples(7, n_frames=6)  # ~9.4k samples < 72-century block
    bank_s, out_s, meta_s = _sharded_bank(mesh)
    bank_p, out_p, meta_p = _plain_bank()
    bank_s.push(samples)
    bank_p.push(samples)
    assert all(len(v) == 0 for v in out_s.values())  # nothing stepped yet
    bank_s.flush()
    bank_p.flush()
    for c in range(C):
        assert out_s[c] == out_p[c]
        assert "".join(meta_s[c]) == "".join(meta_p[c])
    assert any(len(v) > 0 for v in out_p.values())


def _run_parity(mesh, samples, make_sharded, make_plain,
                expect_meta=True):
    """Push the same sample stream through the time-sharded and the
    unsharded tracker banks; bytes and metadata must be identical.
    expect_meta=False for POCSAG, which has no MetaCollector by design
    (messages serialize into the main output — reference
    pocsag_decoder/message.cpp:17-24)."""
    results = {}
    for sharded in (False, True):
        outputs = {c: b"" for c in range(C)}
        on_out = lambda c, d: outputs.__setitem__(c, outputs[c] + d)
        bank = make_sharded(on_out) if sharded else make_plain(on_out)
        if sharded:
            assert samples.shape[1] > bank.pipeline.block_len + 2000
        metas = []
        for c in range(C):
            events = []
            bank.set_meta_writer(c, PipelineMetaWriter(
                lambda b, ev=events: ev.append(b.decode())))
            metas.append(events)
        for lo in range(0, samples.shape[1], 8192):
            bank.push(samples[:, lo:lo + 8192])
        bank.flush()
        results[sharded] = (dict(outputs), ["".join(e) for e in metas])
    assert results[True] == results[False]
    assert any(len(v) > 0 for v in results[False][0].values())
    if expect_meta:
        assert any(len(m) > 0 for m in results[False][1])


def test_timesharded_bank_ysf_equals_unsharded(mesh):
    """YSF (4FSK wide-RRC, 480-dibit frames) through the time-sharded
    tracker bank: byte/event parity incl. FICH cache + DCH metadata."""
    from digiham_jax.pipeline import YsfPipeline
    from digiham_jax.runtime.tracked_bank import YsfAdapter
    from ysf_synth import header_frame, terminator_frame, vd2_frame

    rng = np.random.default_rng(11)
    parts = [rng.integers(0, 4, 60),
             header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  ")]
    for i in range(24):
        parts.append(vd2_frame(i % 8, b"TSHARDYSF "))
    parts.append(terminator_frame())
    parts.append(np.zeros(400, np.uint8))
    dibits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
    base = np.repeat(LEVELS[dibits], 10) * 1000
    samples = np.stack([base + rng.normal(0, 40, base.shape)
                        for _ in range(C)]).astype(np.float32)

    _run_parity(
        mesh, samples,
        lambda cb: TimeShardedTrackedBank(
            TimeShardedPipeline(mesh, channels=C, protocol="ysf"),
            adapter=YsfAdapter(), on_output=cb),
        lambda cb: TrackedChannelBank(
            YsfPipeline(channels=C, sps=10, n_centuries=5),
            adapter=YsfAdapter(), on_output=cb))


def test_timesharded_bank_nxdn_equals_unsharded(mesh):
    """NXDN (4FSK narrow-RRC halo, sps=20) through the time-sharded
    tracker bank: SACCH superframe + VCALL metadata parity."""
    from digiham_jax.pipeline import NxdnPipeline
    from digiham_jax.runtime.tracked_bank import NxdnAdapter
    from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                            vcall_superframe_bytes, voice_slot_dibits)

    rng = np.random.default_rng(13)
    units = vcall_superframe_bytes(1, 1234, 5678)
    payload = rng.integers(0, 4, 72).astype(np.uint8)
    parts = [rng.integers(0, 4, 80)]
    for i in range(22):
        slots = [voice_slot_dibits(payload, 38),
                 voice_slot_dibits(payload, 38 + 72)]
        parts.append(nxdn_frame((0b01, 0b10, 0b11),
                                encode_sacch_unit(i % 4, units[i % 4]),
                                slots))
    parts.append(np.zeros(300, np.uint8))
    dibits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
    base = np.repeat(LEVELS[dibits], 20) * 1000
    samples = np.stack([base + rng.normal(0, 40, base.shape)
                        for _ in range(C)]).astype(np.float32)

    _run_parity(
        mesh, samples,
        lambda cb: TimeShardedTrackedBank(
            TimeShardedPipeline(mesh, channels=C, protocol="nxdn"),
            adapter=NxdnAdapter(), on_output=cb),
        lambda cb: TrackedChannelBank(
            NxdnPipeline(channels=C, sps=20, n_centuries=3),
            adapter=NxdnAdapter(), on_output=cb))


def test_timesharded_bank_pocsag_equals_unsharded(mesh):
    """POCSAG (inverted 2FSK, sps=40, bit domain, serialized-to-stdout
    output) through the time-sharded tracker bank."""
    from digiham_jax.pipeline import FskPipeline
    from digiham_jax.runtime.tracked_bank import PocsagAdapter
    from test_pocsag import (address_codeword, alpha_payloads,
                             build_stream, data_codeword)

    rng = np.random.default_rng(17)
    parts = [np.zeros(100, np.uint8)]
    for m in range(8):
        cws = [address_codeword(1000 + m, 3)]
        cws += [data_codeword(p)
                for p in alpha_payloads(f"TSHARD MSG {m}")]
        parts.append(build_stream(cws))
        parts.append(np.zeros(120, np.uint8))
    bits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
    levels = np.array([1.0, -1.0], np.float32)  # inverted mapping
    base = np.repeat(levels[bits], 40) * 1000
    samples = np.stack([base + rng.normal(0, 60, base.shape)
                        for _ in range(C)]).astype(np.float32)

    _run_parity(
        mesh, samples,
        lambda cb: TimeShardedTrackedBank(
            TimeShardedPipeline(mesh, channels=C, protocol="pocsag"),
            adapter=PocsagAdapter(), on_output=cb),
        lambda cb: TrackedChannelBank(
            FskPipeline(channels=C, protocol="pocsag", n_centuries=2),
            adapter=PocsagAdapter(), on_output=cb),
        expect_meta=False)


def test_timesharded_bank_clock_skew_recentering(mesh):
    """Real streams carry clock skew; the fixed-length time-sharded
    steps start every channel at its own carried pos, so the drift never
    accumulates in the device carry. A skewed stream whose cumulative
    drift (~50 samples) far exceeds a ±24 halo budget must decode
    byte/event-identically to the unsharded bank — and the carried pos
    must stay recentered instead of tripping the budget.

    (Skew accrued WITHIN one device block must fit the halo: at budget
    24 and 72-century blocks that is ~160 ppm — real SDR clocks are
    ±20 ppm. 150 ppm here is ~7x a typical SDR.)"""
    samples = _samples(21, n_frames=240, noise=30.0)
    skew = 1.5e-4  # 150 ppm: ~0.15 samples/century, ~11/block
    n = samples.shape[1]
    t = np.arange(int(n / (1 + skew))) * (1 + skew)
    skewed = np.stack([np.interp(t, np.arange(n), samples[c])
                       for c in range(C)]).astype(np.float32)

    bank_s, out_s, meta_s = _sharded_bank(mesh, drift_budget=24)
    bank_p, out_p, meta_p = _plain_bank()
    for lo in range(0, skewed.shape[1], 8192):
        bank_s.push(skewed[:, lo:lo + 8192])
        bank_p.push(skewed[:, lo:lo + 8192])
    # the device path stepped at least twice and the carry stayed
    # recentered (cumulative skew ~0.0005 * len >> budget 24)
    assert skewed.shape[1] > 2 * bank_s.pipeline.block_len
    # cumulative skew (~0.15 * 345 centuries ~ 50) far exceeds the ±24
    # budget, so surviving WITHOUT tripping check_drift proves the
    # recentering folded the common-mode drift into the stream stride
    assert skew * skewed.shape[1] > bank_s.pipeline.drift_budget
    assert int(np.abs(np.asarray(bank_s.state.pos)).max()) < \
        bank_s.pipeline.drift_budget
    bank_s.flush()
    bank_p.flush()
    for c in range(C):
        assert out_s[c] == out_p[c], f"ch{c} payload diverges"
        assert "".join(meta_s[c]) == "".join(meta_p[c]), \
            f"ch{c} metadata diverges"
    assert any(len(v) > 0 for v in out_p.values())


def test_timesharded_snapshot_restore_under_skew(mesh):
    """snapshot()/restore() mid-stream WHILE drift recentering is
    active: the restored bank must continue byte-identically (the
    variable block stride is a pure function of buffer + carry)."""
    samples = _samples(23, n_frames=200, noise=30.0)
    skew = 1.5e-4
    n = samples.shape[1]
    t = np.arange(int(n / (1 + skew))) * (1 + skew)
    skewed = np.stack([np.interp(t, np.arange(n), samples[c])
                       for c in range(C)]).astype(np.float32)

    bank, outputs, metas = _sharded_bank(mesh, drift_budget=24)
    half = (skewed.shape[1] // 2) // 512 * 512
    bank.push(skewed[:, :half])
    blob = bank.snapshot()

    bank2, outputs2, metas2 = _sharded_bank(mesh, drift_budget=24)
    bank2.restore(blob)
    pre = {c: len(outputs[c]) for c in outputs}
    bank.push(skewed[:, half:])
    bank2.push(skewed[:, half:])
    for c in outputs:
        assert outputs[c][pre[c]:] == outputs2[c]
