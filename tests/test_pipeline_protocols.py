"""Batched YSF/NXDN device stages vs the host decoders."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.pipeline.ysf import (
    decode_fich_batch,
    decode_vd2_voice_batch,
    ysf_decode_frames,
    ysf_sync_correlate,
)
from digiham_jax.pipeline.nxdn import (
    decode_facch1_batch,
    decode_sacch_batch,
    nxdn_sync_correlate,
)
from digiham_jax.protocols.ysf.fich import Fich, encode_fich
from digiham_jax.protocols.ysf.phases import decode_v2_voice, YSF_SYNC

from ysf_synth import encode_v2_voice, make_fich_word, vd2_frame
from nxdn_synth import (
    encode_facch1,
    encode_sacch_unit,
    vcall_superframe_bytes,
)
from digiham_jax.protocols.nxdn.components import (
    MESSAGE_TYPE_TX_RELEASE,
    Scrambler,
)
from digiham_jax.protocols.nxdn.phases import FRAME_SYNC


class TestYsfBatch:
    def test_fich_batch_matches_host(self):
        words = [make_fich_word(1, 2, n) for n in range(6)]
        dibits = np.stack([encode_fich(w) for w in words])
        data, ok = decode_fich_batch(jnp.asarray(dibits))
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(
            np.asarray(data), np.asarray(words, np.uint32))

    def test_fich_batch_rejects_garbage(self):
        rng = np.random.default_rng(0)
        dibits = rng.integers(0, 4, (4, 100)).astype(np.uint8)
        _, ok = decode_fich_batch(jnp.asarray(dibits))
        assert not np.asarray(ok).any()

    def test_vd2_voice_batch_matches_host(self):
        rng = np.random.default_rng(1)
        ambes = [bytes(rng.integers(0, 256, 7).astype(np.uint8))
                 for _ in range(5)]
        dibits = np.stack([encode_v2_voice(a) for a in ambes])
        got = np.asarray(decode_vd2_voice_batch(jnp.asarray(dibits)))
        for i, a in enumerate(ambes):
            want = decode_v2_voice(dibits[i])
            assert got[i].tobytes() == want

    def test_frames_batch(self):
        frames = np.stack([
            np.asarray(vd2_frame(i, b"BATCH     "), np.uint8)
            for i in range(3)])
        fields = ysf_decode_frames(jnp.asarray(frames))
        assert np.asarray(fields["sync_dist"]).tolist() == [0, 0, 0]
        assert np.asarray(fields["fich_ok"]).all()
        assert fields["vd2_voice"].shape == (3, 5, 7)

    def test_sync_correlate(self):
        d = np.random.default_rng(2).integers(0, 4, (1, 200)).astype(np.uint8)
        d[0, 77:97] = YSF_SYNC
        dist = np.asarray(ysf_sync_correlate(jnp.asarray(d)))
        assert dist[0, 77] == 0


class TestNxdnBatch:
    def test_sacch_batch_matches_units(self):
        units = vcall_superframe_bytes(0b001, 4242, 777)
        dibits = np.stack([encode_sacch_unit(i, units[i]) for i in range(4)])
        structure, payload, ok = decode_sacch_batch(jnp.asarray(dibits))
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(structure), [0, 1, 2, 3])
        for i in range(4):
            np.testing.assert_array_equal(np.asarray(payload)[i], units[i])

    def test_facch1_batch(self):
        dibits = np.stack([encode_facch1(MESSAGE_TYPE_TX_RELEASE, 38)
                           for _ in range(3)])
        mtype, ok = decode_facch1_batch(jnp.asarray(dibits))
        assert np.asarray(ok).all()
        assert (np.asarray(mtype) == MESSAGE_TYPE_TX_RELEASE).all()

    def test_sync_correlate(self):
        d = np.zeros((1, 150), np.uint8)
        d[0, 40:50] = FRAME_SYNC
        dist = np.asarray(nxdn_sync_correlate(jnp.asarray(d)))
        assert dist[0, 40] == 0
