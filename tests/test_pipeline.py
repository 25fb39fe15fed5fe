"""Batched device pipeline vs the host phase machine / reference logic."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.pipeline.dmr import (
    DmrPipeline,
    dmr_decode_frames,
    dmr_sync_correlate,
)
from digiham_jax.protocols.dmr.components import (
    DATA_TYPE_VOICE_LC,
    Cach,
    SlotType,
)
from digiham_jax.protocols.dmr.phases import (
    BS_VOICE_SYNC,
    FRAME_SIZE,
    get_sync_type,
    pack_dibits,
)

from dmr_synth import data_frame, group_lc, voice_frame


@pytest.fixture(scope="module")
def frames():
    lc = group_lc(123456, 654321)
    out = []
    for s in range(4):
        out.append(data_frame(s % 2, DATA_TYPE_VOICE_LC, lc))
    for s in range(4):
        out.append(voice_frame(s % 2, np.tile([1, 3, 0, 2], 27), sync=True))
    return np.stack(out)


class TestDecodeFrames:
    def test_fields_match_host(self, frames):
        fields = dmr_decode_frames(jnp.asarray(frames))
        for i, frame in enumerate(frames):
            cach = Cach.parse(frame)
            assert bool(np.asarray(fields["tact_ok"])[i]) == cach.has_tact()
            if cach.has_tact():
                assert int(np.asarray(fields["tact_slot"])[i]) \
                    == cach.tact.slot()
            assert int(np.asarray(fields["sync_type"])[i]) \
                == get_sync_type(frame[66:90])

    def test_voice_payload_packing(self, frames):
        fields = dmr_decode_frames(jnp.asarray(frames))
        payload = np.tile([1, 3, 0, 2], 27)
        for i in range(4, 8):
            got = np.asarray(fields["voice_payload"])[i].tobytes()
            assert got == pack_dibits(payload)

    def test_bptc_lc_bits(self, frames):
        fields = dmr_decode_frames(jnp.asarray(frames))
        ok = np.asarray(fields["bptc_ok"])
        data = np.asarray(fields["bptc_data"])
        assert ok[:4].all()
        lc_bytes = np.packbits(data[0].astype(np.uint8)).tobytes()
        lc = group_lc(123456, 654321)
        assert lc_bytes[:9] == lc

    def test_slot_type(self, frames):
        fields = dmr_decode_frames(jnp.asarray(frames))
        assert np.asarray(fields["slot_type_ok"])[:4].all()
        assert (np.asarray(fields["data_type"])[:4]
                == DATA_TYPE_VOICE_LC).all()


class TestSyncCorrelate:
    def test_matches_direct_distance(self):
        rng = np.random.default_rng(0)
        d = rng.integers(0, 4, (2, 300)).astype(np.uint8)
        d[0, 100:124] = BS_VOICE_SYNC
        dist = np.asarray(dmr_sync_correlate(jnp.asarray(d)))
        assert dist.shape == (2, 277, 4)
        assert dist[0, 100, 1] == 0  # BS voice = pattern row 1
        # cross-check a few offsets against direct computation
        lut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                            axis=1).sum(1)
        for t in (0, 50, 100, 276):
            want = lut[d[0, t:t + 24] ^ BS_VOICE_SYNC].sum()
            assert dist[0, t, 1] == want


class TestPipelineStep:
    def test_two_steps_contiguous(self):
        pipe = DmrPipeline(channels=2, sps=10, n_centuries=2)
        state = pipe.init_state()
        L = 2 * 1001 + 8
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.normal(0, 50, (2, L)).astype(np.float32))
        out1, state = pipe.step(x, state)
        out2, state = pipe.step(x, state)
        assert out1["dibits"].shape == (2, 200)
        assert out1["voice_payload"].shape == (2, 1, 27)
        assert np.asarray(state.demod.pos).min() >= 2 * 2000 - 4
