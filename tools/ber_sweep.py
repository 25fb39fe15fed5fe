"""BER / frame-success characterization vs SNR.

Sweeps AWGN levels over a synthesized DMR 4FSK channel and reports symbol
error rate at the demod output and voice-frame success (bit-exact 27-byte
payload) after the full chain — the "BER vs reference" north-star metric
(BASELINE.md). Run on CPU or GPU.

Usage: python tools/ber_sweep.py [channels]
"""
import sys

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, "tests")

from digiham_jax.dsp.demod import demod_init, gfsk_demod_block
from digiham_jax.dsp.rrc import WIDE_RRC, RrcState, rrc_filter
from digiham_jax.protocols.dmr import make_decoder
from digiham_jax.protocols.dmr.phases import pack_dibits

from dmr_synth import voice_frame  # noqa: E402

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
SPS = 10


def run_point(snr_db: float, n_frames: int = 40, seed: int = 0):
    rng = np.random.default_rng(seed)
    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True)
              for s in range(n_frames)]
    tx = np.concatenate([np.zeros(60, np.uint8)] + frames)
    sig = np.repeat(LEVELS[tx], SPS).astype(np.float32)
    # symbol energy ~ mean(levels^2); AWGN sigma from SNR
    p_sig = np.mean((LEVELS[tx]) ** 2)
    sigma = np.sqrt(p_sig / (10 ** (snr_db / 10)))
    noisy = (sig + rng.normal(0, sigma, len(sig))).astype(np.float32) * 1000

    filt, _ = rrc_filter(jnp.asarray(noisy)[None, :],
                         RrcState.init(1, WIDE_RRC), WIDE_RRC)
    n_cent = (len(noisy) // SPS - 2) // 100
    rx, _ = gfsk_demod_block(filt, demod_init(1), n_cent, SPS)
    rx = np.asarray(rx)[0]

    # symbol error rate against aligned tx (RRC group delay = 40 samples
    # = 4 symbols; demod may also slew — correlate to find alignment)
    best_err, best_off = 1.0, 0
    for off in range(0, 12):
        n = min(len(rx) - off, len(tx))
        err = np.mean(rx[off:off + n] != tx[:n])
        if err < best_err:
            best_err, best_off = err, off

    out = make_decoder().process(rx)
    want = pack_dibits(payload)
    n_exact = sum(out[i:i + 27] == want for i in range(0, len(out), 27))
    # TDMA: bursts alternate slots and active-slot arbitration emits only
    # the first-locked slot, so the ceiling is n_frames/2
    return best_err, n_exact, n_frames // 2


def main():
    print(f"{'SNR dB':>7} {'SER':>10} {'frames ok':>12}")
    for snr in (30, 20, 15, 12, 10, 8, 6, 4):
        ser, ok, total = run_point(snr)
        print(f"{snr:7.0f} {ser:10.4f} {ok:6d}/{total:<5d}")


if __name__ == "__main__":
    main()
