"""Raw-IQ ingest variant of the DMR pipeline."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.pipeline import DmrPipeline
from digiham_jax.protocols.dmr.phases import pack_dibits

from dmr_synth import voice_frame

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
FS, DEV, SPS = 48000.0, 1944.0, 10


def modulate(dibits):
    freq = np.repeat(LEVELS[np.asarray(dibits)], SPS) * DEV
    phase = 2 * np.pi * np.cumsum(freq) / FS
    return np.exp(1j * phase).astype(np.complex64)


def test_step_iq_decodes_dmr():
    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(6)]
    dibits = np.concatenate([np.zeros(40, np.uint8)] + frames)
    iq = modulate(dibits)

    pipe = DmrPipeline(channels=1, sps=SPS, n_centuries=5)
    state = pipe.init_state()
    L = 5 * (100 * SPS + 1) + 8
    iq_in = np.zeros((1, L), np.complex64)
    iq_in[0, :min(L, len(iq))] = iq[:L]
    out, carry, state = pipe.step_iq(
        jnp.asarray(iq_in), jnp.ones((1,), jnp.complex64), state)
    rx = np.asarray(out["dibits"])[0]
    # the voice payload should appear bit-exact in the decoded stream
    from digiham_jax.protocols.dmr import make_decoder
    decoded = make_decoder().process(rx)
    assert pack_dibits(payload) in decoded
    assert carry.shape == (1,)
