"""End-to-end many-channel bank: device pipeline + per-channel decoders."""
import numpy as np
import pytest

from digiham_jax.pipeline import DmrPipeline
from digiham_jax.protocols.dmr import make_decoder
from digiham_jax.protocols.dmr.phases import pack_dibits
from digiham_jax.runtime.channel_bank import ChannelBank
from digiham_jax.runtime.meta import PipelineMetaWriter

from dmr_synth import voice_frame


LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def synth(dibits, sps=10, amp=1000.0):
    return (np.repeat(LEVELS[np.asarray(dibits)], sps) * amp
            ).astype(np.float32)


class TestChannelBank:
    def test_multi_channel_decode(self):
        channels = 4
        sps = 10
        # NOTE: payloads must contain outer symbols (1/3): with only inner
        # levels on air, the AGC window between syncs sees no full-scale
        # samples and mis-slices — reference behavior too.
        payloads = [np.tile([1, 3, 0, 2], 27),
                    np.tile([2, 0, 3, 1], 27),
                    np.tile([3, 3, 1, 1], 27),
                    np.tile([0, 3, 2, 1], 27)]
        streams = []
        for c in range(channels):
            frames = [voice_frame(s % 2, payloads[c], sync=True)
                      for s in range(10)]
            dibits = np.concatenate(
                [np.zeros(40, np.uint8)] + frames)
            streams.append(synth(dibits, sps))
        min_len = min(len(s) for s in streams)
        samples = np.stack([s[:min_len] for s in streams])

        outputs = {c: b"" for c in range(channels)}

        def on_output(c, data):
            outputs[c] += data

        pipe = DmrPipeline(channels=channels, sps=sps, n_centuries=2)
        bank = ChannelBank(pipe, [make_decoder() for _ in range(channels)],
                           on_output=on_output)
        events = []
        for c, dec in enumerate(bank.decoders):
            dec.set_meta_writer(PipelineMetaWriter(
                lambda b, c=c: events.append((c, b.decode()))))

        # stream in chunks, like ingest would
        for lo in range(0, samples.shape[1], 4096):
            bank.push(samples[:, lo:lo + 4096])

        for c in range(channels):
            want = pack_dibits(payloads[c])
            got = outputs[c]
            assert len(got) >= 27 * 3, f"channel {c} produced {len(got)}"
            n_match = sum(got[i:i + 27] == want
                          for i in range(0, len(got), 27))
            assert n_match >= 3, f"channel {c}"
        # every channel reported voice sync
        synced = {c for c, e in events if "sync:voice" in e}
        assert synced == set(range(channels))

    def test_states_independent_across_channels(self):
        """One channel of noise must not disturb its neighbors."""
        channels = 2
        payload = np.tile([1, 3, 0, 2], 27)
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(8)]
        good = synth(np.concatenate(frames))
        rng = np.random.default_rng(0)
        noise = rng.normal(0, 300, len(good)).astype(np.float32)
        samples = np.stack([good, noise])

        outputs = {0: b"", 1: b""}
        pipe = DmrPipeline(channels=channels, sps=10, n_centuries=2)
        bank = ChannelBank(pipe, [make_decoder() for _ in range(channels)],
                           on_output=lambda c, d: outputs.__setitem__(
                               c, outputs[c] + d))
        bank.push(samples)
        assert len(outputs[0]) >= 27 * 3
        assert pack_dibits(payload) in outputs[0]


class TestStreamedRrcCarry:
    def test_streamed_blocks_match_one_shot(self):
        """Block-streamed decode through the bank must be bit-identical to
        one big-block run: regression for the RRC delay-line realignment
        on buffer rebase (rrc_rebase_history) — the consumed prefix is
        shorter than the filtered block, so the carried history must be
        the raw samples before the new origin, not the block tail."""
        import jax.numpy as jnp

        rng = np.random.default_rng(7)
        C, sps, n_cent, blocks = 2, 10, 2, 4
        need = n_cent * (100 * sps + 1) + 2
        x = rng.normal(0, 1000, (C, blocks * need)).astype(np.float32)

        big = DmrPipeline(channels=C, sps=sps, n_centuries=blocks * n_cent,
                          use_rrc=True)
        out_big, _ = big.step(jnp.asarray(x), big.init_state())
        want = np.asarray(out_big["dibits"])

        bank = ChannelBank(
            DmrPipeline(channels=C, sps=sps, n_centuries=n_cent,
                        use_rrc=True),
            [None] * C)
        results = bank.push(x)
        got = np.concatenate(
            [np.asarray(r["dibits"]) for r in results], axis=1)
        n = min(got.shape[1], want.shape[1])
        assert n >= blocks * n_cent * 100 - n_cent * 100
        np.testing.assert_array_equal(got[:, :n], want[:, :n])
