"""Auxiliary runtime subsystems: metrics, checkpoint/resume, syndrome tool."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.runtime.metrics import MetricsRegistry, StageMeter
from digiham_jax.runtime.checkpoint import (
    load_decoder,
    load_state,
    save_decoder,
    save_state,
)


class TestMetrics:
    def test_meter_rates(self):
        m = StageMeter("demod", "samples")
        with m.measure(48000):
            pass
        assert m.items == 48000 and m.calls == 1
        snap = m.snapshot()
        assert snap["stage"] == "demod" and snap["rate_per_s"] > 0

    def test_registry_report(self):
        lines = []
        reg = MetricsRegistry(sink=lines.append)
        with reg.meter("rrc").measure(1000):
            pass
        reg.report()
        assert any("rrc" in line for line in lines)


class TestCheckpoint:
    def test_demod_state_roundtrip(self):
        from digiham_jax.dsp.demod import demod_init, gfsk_demod_block
        state = demod_init(2)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(0, 100, (2, 1020)).astype(np.float32))
        _, state = gfsk_demod_block(x, state, 1, 10)
        blob = save_state(state)
        restored = load_state(blob)
        np.testing.assert_array_equal(np.asarray(state.pos),
                                      restored.pos)
        np.testing.assert_array_equal(np.asarray(state.volume_ring),
                                      restored.volume_ring)

    def test_resume_is_bit_exact(self):
        """Decode continues identically after a snapshot/restore."""
        from digiham_jax.dsp.demod import demod_init, gfsk_demod_block
        rng = np.random.default_rng(1)
        levels = np.array([1.0, 3.0, -1.0, -3.0]) * 300
        tx = rng.integers(0, 4, 450)
        sig = np.repeat(levels[tx], 10).astype(np.float32)[None, :]
        state = demod_init(1)
        a, state = gfsk_demod_block(jnp.asarray(sig[:, :4200]), state, 2, 10)
        blob = save_state(state)
        b1, _ = gfsk_demod_block(jnp.asarray(sig[:, :4400]),
                                 state, 2, 10)
        b2, _ = gfsk_demod_block(jnp.asarray(sig[:, :4400]),
                                 load_state(blob), 2, 10)
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))

    def test_decoder_snapshot(self):
        from digiham_jax.protocols.dmr import make_decoder
        import sys, os
        sys.path.insert(0, os.path.dirname(__file__))
        from dmr_synth import voice_frame
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(6)]
        stream = np.concatenate(frames)
        dec = make_decoder()
        out1 = dec.process(stream[:500])
        blob = save_decoder(dec)
        rest = load_decoder(blob)
        a = dec.process(stream[500:])
        b = rest.process(stream[500:])
        assert a == b


class TestSyndromeTool:
    def test_all_codes_self_check(self):
        from digiham_jax.fec.syndrome_tool import main
        assert main([]) == 0

    def test_dump_one(self, capsys):
        from digiham_jax.fec.syndrome_tool import main
        assert main(["--dump", "hamming_7_4"]) == 0
        out = capsys.readouterr().out
        assert out.count("{") >= 7  # at least the single-bit patterns


class TestMetricsWiring:
    """SURVEY §5 first-class rate instrumentation: the production paths
    (StreamDriver, TrackedChannelBank) feed the process registry."""

    def test_stream_driver_feeds_meter(self):
        import numpy as np
        from digiham_jax.dsp.demod import demod_init, gfsk_demod_block
        from digiham_jax.runtime.metrics import REGISTRY
        from digiham_jax.runtime.stream import StreamDriver

        def fn(block, state, n_centuries):
            return gfsk_demod_block(block, state, n_centuries, 10)

        drv = StreamDriver(2, 10, fn, demod_init(2), n_centuries=1)
        meter = REGISTRY.meters["stream_driver[2ch]"]
        before = meter.items
        drv.push(np.zeros((2, 1500), np.float32))
        assert meter.items == before + 2 * 100 * 10
        assert meter.rate > 0

    def test_tracked_bank_feeds_meter_and_reports(self, capsys):
        import numpy as np
        from digiham_jax.pipeline import DmrPipeline
        from digiham_jax.runtime.metrics import REGISTRY
        from digiham_jax.runtime.tracked_bank import TrackedChannelBank

        bank = TrackedChannelBank(
            DmrPipeline(channels=1, sps=10, n_centuries=2, use_rrc=False))
        meter = REGISTRY.meters["tracked_bank[1ch]"]
        before = meter.items
        lines = []
        old_every, old_sink = REGISTRY.report_every, REGISTRY.sink
        REGISTRY.report_every, REGISTRY.sink = 1e-9, lines.append
        try:
            bank.push(np.zeros((1, 2 * (100 * 10 + 1) + 100), np.float32))
        finally:
            REGISTRY.report_every, REGISTRY.sink = old_every, old_sink
        assert meter.items == before + 2 * 100 * 10
        assert any('"rate_per_s"' in ln and "tracked_bank[1ch]" in ln
                   for ln in lines)

    def test_metrics_every_env_read_lazily(self, monkeypatch):
        # setting DIGIHAM_METRICS_EVERY *after* import must take effect
        # (round-2 advisor: it used to be read once at module import)
        from digiham_jax.runtime.metrics import MetricsRegistry

        reg = MetricsRegistry()
        lines = []
        reg.sink = lines.append
        reg.meter("lazy_env_stage")
        monkeypatch.delenv("DIGIHAM_METRICS_EVERY", raising=False)
        reg.maybe_report()
        assert not lines
        monkeypatch.setenv("DIGIHAM_METRICS_EVERY", "1e-9")
        reg._last_report = 0.0
        reg.maybe_report()
        assert any("lazy_env_stage" in ln for ln in lines)
        # explicit report_every wins over the env var
        lines.clear()
        reg.report_every = 0.0
        reg._last_report = 0.0
        reg.maybe_report()
        assert not lines


class TestEnvFlag:
    def test_strict_parsing(self, monkeypatch):
        from digiham_jax.utils import env_flag

        monkeypatch.delenv("DIGIHAM_TEST_FLAG", raising=False)
        assert env_flag("DIGIHAM_TEST_FLAG") is None
        for v in ("1", "true", "ON", "Yes"):
            monkeypatch.setenv("DIGIHAM_TEST_FLAG", v)
            assert env_flag("DIGIHAM_TEST_FLAG") is True, v
        for v in ("0", "false", "OFF", "no", ""):
            monkeypatch.setenv("DIGIHAM_TEST_FLAG", v)
            assert env_flag("DIGIHAM_TEST_FLAG") is False, v
        # unrecognized values are ignored (not treated as enable)
        import warnings
        monkeypatch.setenv("DIGIHAM_TEST_FLAG", "maybe")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert env_flag("DIGIHAM_TEST_FLAG") is None
            assert len(w) == 1
