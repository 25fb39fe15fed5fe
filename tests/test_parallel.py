"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from digiham_jax.dsp.rrc import WIDE_RRC, RrcState, rrc_filter_block
from digiham_jax.parallel import (
    make_mesh,
    sharded_pipeline_step,
    sharded_rrc_filter,
)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return devs


class TestShardedRrc:
    def test_matches_single_device(self, devices):
        """Time-sharded overlap-save output == unsharded streaming run."""
        mesh = make_mesh(n_channel_shards=2, n_time_shards=4)
        rng = np.random.default_rng(0)
        C, T = 4, 4 * 512
        x = rng.normal(0, 1, (C, T)).astype(np.float32)
        want, _ = rrc_filter_block(
            jnp.asarray(x), RrcState.init(C, WIDE_RRC), WIDE_RRC)
        got = sharded_rrc_filter(mesh, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)

    def test_shard_count_invariance(self, devices):
        """Same bits whether split 2 ways or 4 ways on the time axis."""
        rng = np.random.default_rng(1)
        C, T = 2, 2048
        x = jnp.asarray(rng.normal(0, 1, (C, T)).astype(np.float32))
        a = sharded_rrc_filter(make_mesh(2, 2), x)
        b = sharded_rrc_filter(make_mesh(2, 4), x)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


class TestShardedPipeline:
    def test_full_step_compiles_and_runs(self, devices):
        mesh = make_mesh(n_channel_shards=4, n_time_shards=2)
        sps, n_cent = 10, 2
        t_local = n_cent * (100 * sps + 1) + 4
        C, T = 8, 2 * t_local
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.normal(0, 100, (C, T)).astype(np.float32))
        voice, hits = sharded_pipeline_step(mesh, x, sps, n_cent)
        assert voice.shape[0] == C
        assert voice.shape[-1] == 27
        assert hits.shape == (C,)


class TestShardedFsk:
    def test_dstar_step_matches_single_device(self, devices):
        """Channel+time sharded 2FSK step == unsharded bulk decode."""
        from digiham_jax.dsp.demod import demod_init, fsk_demod_block
        from digiham_jax.parallel import make_mesh, sharded_fsk_step
        from digiham_jax.pipeline.fsk import dstar_decode_frames

        mesh = make_mesh(n_channel_shards=2, n_time_shards=4)
        rng = np.random.default_rng(5)
        C, n_cent, sps = 4, 2, 10
        T_local = n_cent * (100 * sps + 1) + 1
        x = rng.normal(0, 500, (C, 4 * T_local)).astype(np.float32)
        voice, hits = sharded_fsk_step(mesh, jnp.asarray(x),
                                       protocol="dstar",
                                       n_centuries=n_cent)
        assert voice.shape[0] == C and voice.shape[2] == 9
        assert hits.shape == (C,)
        # single-device reference over each time shard independently
        # (bulk mode: fresh demod state per shard, like the sharded step)
        for t in range(4):
            xs = jnp.asarray(x[:, t * T_local:(t + 1) * T_local])
            bits, _ = fsk_demod_block(xs, demod_init(C), n_cent, sps, False)
            n = (bits.shape[1] - 24) // 96
            windows = jnp.stack(
                [bits[:, i * 96:i * 96 + 120] for i in range(n)], axis=1)
            want = np.asarray(dstar_decode_frames(windows)["voice"])
            got = np.asarray(voice)[:, t * n:(t + 1) * n]
            np.testing.assert_array_equal(got, want)

    def test_pocsag_step_compiles_and_runs(self, devices):
        from digiham_jax.parallel import make_mesh, sharded_fsk_step

        mesh = make_mesh(n_channel_shards=4, n_time_shards=2)
        rng = np.random.default_rng(6)
        C, n_cent, sps = 4, 1, 40
        T_local = n_cent * (100 * sps + 1) + 1
        x = rng.normal(0, 500, (C, 2 * T_local)).astype(np.float32)
        ok, hits = sharded_fsk_step(mesh, jnp.asarray(x),
                                    protocol="pocsag",
                                    n_centuries=n_cent)
        assert ok.shape[0] == C and hits.shape == (C,)


class TestShardedValueEquivalence:
    """VERDICT round-1 item 3: exact-array asserts for the DMR and POCSAG
    mesh steps, mirroring the existing D-Star check."""

    def test_dmr_step_matches_single_device(self, devices):
        from digiham_jax.dsp.demod import demod_init, gfsk_demod_block
        from digiham_jax.pipeline.dmr import (dmr_decode_frames,
                                              dmr_sync_correlate)
        from digiham_jax.protocols.dmr.phases import FRAME_SIZE

        mesh = make_mesh(n_channel_shards=2, n_time_shards=4)
        rng = np.random.default_rng(21)
        C, n_cent, sps = 4, 2, 10
        T_local = n_cent * (100 * sps + 1) + 1
        x = rng.normal(0, 500, (C, 4 * T_local)).astype(np.float32)
        voice, hits = sharded_pipeline_step(mesh, jnp.asarray(x),
                                            sps, n_cent)
        # single-device reference: full-width RRC (zero state == shard-0
        # halo of zeros; interior halos == overlap-save), then per-shard
        # fresh-state demod + frame decode (bulk mode semantics)
        y_full, _ = rrc_filter_block(
            jnp.asarray(x), RrcState.init(C, WIDE_RRC), WIDE_RRC)
        want_hits = np.zeros(C, np.int64)
        for t in range(4):
            ys = y_full[:, t * T_local:(t + 1) * T_local]
            dibits, _ = gfsk_demod_block(ys, demod_init(C), n_cent, sps)
            sync_dist = np.asarray(dmr_sync_correlate(dibits))
            want_hits += ((sync_dist <= 3).any(-1)).sum(-1)
            n = dibits.shape[1] // FRAME_SIZE
            frames = dibits[:, :n * FRAME_SIZE].reshape(C, n, FRAME_SIZE)
            want = np.asarray(
                dmr_decode_frames(frames)["voice_payload"])
            got = np.asarray(voice)[:, t * n:(t + 1) * n]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"time shard {t}")
        np.testing.assert_array_equal(np.asarray(hits), want_hits)

    def test_pocsag_step_matches_single_device(self, devices):
        from digiham_jax.dsp.demod import demod_init, fsk_demod_block
        from digiham_jax.parallel import sharded_fsk_step
        from digiham_jax.pipeline.fsk import (bit_sync_correlate,
                                              pocsag_decode_frames)
        from digiham_jax.protocols.pocsag import SYNC_PATTERN

        mesh = make_mesh(n_channel_shards=4, n_time_shards=2)
        rng = np.random.default_rng(22)
        C, n_cent, sps = 4, 1, 40
        T_local = n_cent * (100 * sps + 1) + 1
        x = rng.normal(0, 500, (C, 2 * T_local)).astype(np.float32)
        ok, hits = sharded_fsk_step(mesh, jnp.asarray(x),
                                    protocol="pocsag", n_centuries=n_cent)
        want_hits = np.zeros(C, np.int64)
        for t in range(2):
            xs = jnp.asarray(x[:, t * T_local:(t + 1) * T_local])
            bits, _ = fsk_demod_block(xs, demod_init(C), n_cent, sps, True)
            want_hits += (np.asarray(
                bit_sync_correlate(bits, SYNC_PATTERN)) <= 3).sum(-1)
            n = bits.shape[1] // 32
            want = np.asarray(pocsag_decode_frames(
                bits[:, :n * 32].reshape(C, n, 32))["ok"])
            got = np.asarray(ok)[:, t * n:(t + 1) * n]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"time shard {t}")
        np.testing.assert_array_equal(np.asarray(hits), want_hits)


class TestShardedGfskProtocols:
    """sharded_gfsk_step value-equivalence for YSF and NXDN (DMR's
    equivalent lives in test_dmr_step_matches_single_device)."""

    def _run(self, protocol, sps, n_cent, devices):
        import numpy as np
        from digiham_jax.dsp.demod import demod_init, gfsk_demod_block
        from digiham_jax.dsp.rrc import (NARROW_RRC, WIDE_RRC, RrcState,
                                         rrc_filter_block)
        from digiham_jax.parallel import make_mesh, sharded_gfsk_step
        from digiham_jax.parallel.sharded import _gfsk_config

        design, sps_, frame_size, sync_fn, decode_fn = \
            _gfsk_config(protocol)
        assert sps_ == sps
        C, NT = 4, 2
        mesh = make_mesh(n_channel_shards=2, n_time_shards=NT,
                         devices=devices[:4])
        T_local = n_cent * (100 * sps + 1) + 1
        rng = np.random.default_rng(11)
        x = rng.normal(0, 700, (C, NT * T_local)).astype(np.float32)

        fields, hits = sharded_gfsk_step(mesh, jnp.asarray(x), protocol,
                                         n_cent)
        jax.block_until_ready(fields)

        # single-device reference: full-width RRC from zero state (equal
        # to halo-exchanged shards), then per-time-shard demod/decode
        y, _ = rrc_filter_block(jnp.asarray(x),
                                RrcState.init(C, design), design)
        want_hits = np.zeros(C, np.int64)
        want_fields = []
        for t in range(NT):
            ys = y[:, t * T_local:(t + 1) * T_local]
            dibits, _ = gfsk_demod_block(ys, demod_init(C), n_cent, sps)
            dist = np.asarray(sync_fn(dibits))
            want_hits += (dist <= 3).reshape(C, -1).sum(-1)
            n = dibits.shape[1] // frame_size
            frames = dibits[:, :n * frame_size].reshape(C, n, frame_size)
            want_fields.append(jax.tree.map(np.asarray,
                                            decode_fn(frames)))
        for key in want_fields[0]:
            want = np.concatenate([w[key] for w in want_fields], axis=1)
            np.testing.assert_array_equal(
                np.asarray(fields[key]), want, err_msg=key)
        np.testing.assert_array_equal(np.asarray(hits), want_hits)

    def test_ysf_step_matches_single_device(self, devices):
        self._run("ysf", 10, 5, devices)

    def test_nxdn_step_matches_single_device(self, devices):
        self._run("nxdn", 20, 2, devices)
