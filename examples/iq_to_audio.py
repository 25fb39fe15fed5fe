"""End-to-end demo: raw IQ file -> DMR decode -> AMBE frames (+ PCM when a
codecserver is reachable) + metadata events.

Usage:
  python examples/iq_to_audio.py <iq_file.cf32> [--meta meta.txt]
                                 [--ambe out.ambe] [--codecserver PATH]

With no arguments, synthesizes a demo DMR transmission and decodes it.
"""
import argparse
import sys

import numpy as np
import jax.numpy as jnp

from digiham_jax.dsp import (
    RrcState, WIDE_RRC, demod_init, fm_discriminator, gfsk_demod_block,
    rrc_filter,
)
from digiham_jax.protocols.dmr import make_decoder
from digiham_jax.runtime.meta import FileMetaWriter, PipelineMetaWriter


def synth_demo_iq():
    sys.path.insert(0, "tests")
    from dmr_synth import voice_frame
    levels = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
    payload = np.tile([1, 3, 0, 2], 27)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(20)]
    dibits = np.concatenate([np.zeros(50, np.uint8)] + frames)
    freq = np.repeat(levels[dibits], 10) * 1944.0
    phase = 2 * np.pi * np.cumsum(freq) / 48000.0
    return np.exp(1j * phase).astype(np.complex64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("iq_file", nargs="?", help="complex64 IQ file @48kS/s")
    ap.add_argument("--meta", help="metadata output file")
    ap.add_argument("--ambe", help="write packed voice frames here")
    ap.add_argument("--codecserver", help="synthesize PCM via codecserver")
    args = ap.parse_args()

    if args.iq_file:
        iq = np.fromfile(args.iq_file, np.complex64)
    else:
        print("no IQ file given - synthesizing a demo DMR transmission",
              file=sys.stderr)
        iq = synth_demo_iq()

    audio, _ = fm_discriminator(jnp.asarray(iq)[None, :],
                                jnp.ones((1,), jnp.complex64))
    filtered, _ = rrc_filter(audio * 5000, RrcState.init(1, WIDE_RRC),
                             WIDE_RRC)
    n_cent = (filtered.shape[1] // 10 - 2) // 100
    dibits, _ = gfsk_demod_block(filtered, demod_init(1), n_cent, 10)

    dec = make_decoder()
    if args.meta:
        dec.set_meta_writer(FileMetaWriter(args.meta))
    else:
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b: sys.stderr.write("meta: " + b.decode())))
    voice = dec.process(np.asarray(dibits)[0])
    print(f"decoded {len(voice)} voice payload bytes "
          f"({len(voice)//27} DMR bursts)", file=sys.stderr)

    if args.ambe:
        with open(args.ambe, "wb") as f:
            f.write(voice)
    if args.codecserver:
        from digiham_jax.codec import MbeSynthesizer, TableMode
        synth = MbeSynthesizer(args.codecserver,
                               pcm_sink=sys.stdout.buffer.write)
        synth.set_mode(TableMode(33))
        synth.process(voice)
        import time
        time.sleep(1.0)
        synth.close()


if __name__ == "__main__":
    main()
