"""Long-run stability: the channel bank must hold bounded buffers and
cursors over many blocks (hours-equivalent of stream time)."""
import numpy as np
import pytest

from digiham_jax.pipeline import DmrPipeline
from digiham_jax.protocols.dmr import make_decoder
from digiham_jax.runtime.channel_bank import ChannelBank

from dmr_synth import voice_frame

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def test_bank_bounded_over_many_blocks():
    channels = 2
    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(40)]
    sig = (np.repeat(LEVELS[np.concatenate(frames)], 10) * 1000
           ).astype(np.float32)
    # add a timing drift so the slew logic stays active. NOTE the design
    # envelope (same as the reference): the timing loop corrects at most
    # 1 sample per 100 symbols = 0.1% clock offset; 1/1500 (0.067%) is
    # trackable, 1/997 is just beyond it and loses lock.
    keep = np.ones(len(sig), bool)
    keep[::1500] = False
    drifted = sig[keep]
    stream = np.tile(drifted, 12)  # ~8M samples = ~170 s of channel time
    samples = np.stack([stream, stream * 0.7])

    out_total = [0, 0]
    pipe = DmrPipeline(channels=channels, sps=10, n_centuries=4)
    bank = ChannelBank(pipe, [make_decoder() for _ in range(channels)],
                       on_output=lambda c, d: out_total.__setitem__(
                           c, out_total[c] + len(d)))
    max_fill = 0
    max_pos = 0
    for lo in range(0, samples.shape[1] - 8192, 8192):
        bank.push(samples[:, lo:lo + 8192])
        max_fill = max(max_fill, bank.buffer.fill)
        max_pos = max(max_pos, int(np.asarray(bank.state.demod.pos).max()))
    # buffers and cursors stay bounded (rebase works under drift)
    assert max_fill < 64 * 1024
    assert max_pos < 16 * 1024
    # decode continued throughout despite the drift
    assert out_total[0] > 20 * 27


def test_tracked_bank_bounded_under_drift():
    """TrackedChannelBank (sample path) under trackable clock drift."""
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank
    channels = 2
    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(40)]
    sig = (np.repeat(LEVELS[np.concatenate(frames)], 10) * 1000
           ).astype(np.float32)
    keep = np.ones(len(sig), bool)
    keep[::1500] = False
    drifted = sig[keep]
    stream = np.tile(drifted, 8)
    samples = np.stack([stream, stream * 0.8])

    out_total = [0]
    pipe = DmrPipeline(channels=channels, sps=10, n_centuries=4)
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: out_total.__setitem__(
            0, out_total[0] + len(d)))
    max_fill = 0
    max_buf = 0
    for lo in range(0, samples.shape[1] - 8192, 8192):
        bank.push(samples[:, lo:lo + 8192])
        max_fill = max(max_fill, bank.samples.fill)
        max_buf = max(max_buf, max(len(ch.buffer) for ch in bank.chans))
    assert max_fill < 64 * 1024
    assert max_buf < 16 * 1024   # dibit buffers bounded
    assert out_total[0] > 40 * 27


def test_dstar_tracked_bank_bounded_on_noise():
    """Idle (pure-noise) D-Star channels must hold bounded dibit buffers:
    the hunt (incl. transient header-pending states) may never accumulate
    more than its lookahead plus one header span."""
    from digiham_jax.pipeline import FskPipeline
    from digiham_jax.runtime.tracked_bank import (DstarAdapter,
                                                  TrackedChannelBank)
    rng = np.random.default_rng(3)
    samples = rng.normal(0, 400, (2, 600_000)).astype(np.float32)
    pipe = FskPipeline(channels=2, protocol="dstar", n_centuries=4)
    bank = TrackedChannelBank(pipe, adapter=DstarAdapter())
    max_buf = 0
    for lo in range(0, samples.shape[1] - 8192, 8192):
        bank.push(samples[:, lo:lo + 8192])
        max_buf = max(max_buf, max(len(ch.buffer) for ch in bank.chans))
    assert max_buf < 4 * 1024
    assert bank.samples.fill < 64 * 1024


def test_pocsag_tracked_bank_bounded_on_noise():
    from digiham_jax.pipeline import FskPipeline
    from digiham_jax.runtime.tracked_bank import (PocsagAdapter,
                                                  TrackedChannelBank)
    rng = np.random.default_rng(4)
    samples = rng.normal(0, 400, (2, 1_200_000)).astype(np.float32)
    pipe = FskPipeline(channels=2, protocol="pocsag", n_centuries=4)
    bank = TrackedChannelBank(pipe, adapter=PocsagAdapter())
    max_buf = 0
    for lo in range(0, samples.shape[1] - 16384, 16384):
        bank.push(samples[:, lo:lo + 16384])
        max_buf = max(max_buf, max(len(ch.buffer) for ch in bank.chans))
    assert max_buf < 4 * 1024
    assert bank.samples.fill < 128 * 1024
