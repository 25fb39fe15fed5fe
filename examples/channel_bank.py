"""Many-channel decoding example: a protocol bank on one chip, production
topology — device pipeline (filter + demod + batched frame-field decode)
feeding host trackers that do control flow only. Works for all five
protocols.

Usage: python examples/channel_bank.py [protocol] [channels] [steps]
       protocol in {dmr, ysf, nxdn, dstar, pocsag} (default dmr)
"""
import sys

import numpy as np

from digiham_jax.runtime.metrics import REGISTRY
from digiham_jax.runtime.tracked_bank import TrackedChannelBank

sys.path.insert(0, "tests")

FOUR_LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def synth_dmr(channels, n_sym, rng):
    from dmr_synth import voice_frame

    rows = []
    for c in range(channels):
        payload = rng.integers(0, 4, 108)
        frames = [voice_frame(s % 2, payload, sync=True)
                  for s in range(n_sym // 144 + 1)]
        dibits = np.concatenate(frames)[:n_sym]
        rows.append(np.repeat(FOUR_LEVELS[dibits], 10) * 1000)
    return np.stack(rows).astype(np.float32), 10


def synth_ysf(channels, n_sym, rng):
    from ysf_synth import header_frame, vd2_frame

    rows = []
    for c in range(channels):
        parts = [header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  ")]
        parts += [vd2_frame(i % 8, b"CHANNEL%02d " % (c % 100))
                  for i in range(n_sym // 480 + 1)]
        dibits = np.concatenate(parts)[:n_sym]
        rows.append(np.repeat(FOUR_LEVELS[dibits], 10) * 1000)
    return np.stack(rows).astype(np.float32), 10


def synth_nxdn(channels, n_sym, rng):
    from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                            vcall_superframe_bytes, voice_slot_dibits)

    rows = []
    for c in range(channels):
        units = vcall_superframe_bytes(1, 1000 + c, 2000 + c)
        payload = rng.integers(0, 4, 72).astype(np.uint8)
        parts = []
        for i in range(n_sym // 192 + 1):
            parts.append(nxdn_frame(
                (0b01, 0b10, 0b11),
                encode_sacch_unit(i % 4, units[i % 4]),
                [voice_slot_dibits(payload, 38),
                 voice_slot_dibits(payload, 110)]))
        dibits = np.concatenate(parts)[:n_sym]
        rows.append(np.repeat(FOUR_LEVELS[dibits], 20) * 1000)
    return np.stack(rows).astype(np.float32), 20


def synth_dstar(channels, n_sym, rng):
    from test_dstar import full_voice_stream

    levels = np.array([-1.0, 1.0], np.float32)
    rows = []
    for c in range(channels):
        bits = np.concatenate(full_voice_stream(n_sym // 96 + 2))[:n_sym]
        rows.append(np.repeat(levels[bits], 10) * 1000)
    return np.stack(rows).astype(np.float32), 10


def synth_pocsag(channels, n_sym, rng):
    from test_pocsag import (address_codeword, alpha_payloads,
                             build_stream, data_codeword)

    levels = np.array([1.0, -1.0], np.float32)  # inverted FSK
    rows = []
    for c in range(channels):
        cws = [address_codeword(1000 + c, 3)]
        cws += [data_codeword(p) for p in alpha_payloads("BANK %d" % c)]
        one = build_stream(cws, preamble_bits=64)
        bits = np.tile(one, n_sym // len(one) + 1)[:n_sym]
        rows.append(np.repeat(levels[bits], 40) * 1000)
    return np.stack(rows).astype(np.float32), 40


def build(protocol, channels):
    if protocol == "dmr":
        from digiham_jax.pipeline import DmrPipeline
        return DmrPipeline(channels=channels, sps=10, n_centuries=4), \
            None, synth_dmr
    if protocol == "ysf":
        from digiham_jax.pipeline import YsfPipeline
        from digiham_jax.runtime.tracked_bank import YsfAdapter
        return YsfPipeline(channels=channels, sps=10, n_centuries=10), \
            YsfAdapter(), synth_ysf
    if protocol == "nxdn":
        from digiham_jax.pipeline import NxdnPipeline
        from digiham_jax.runtime.tracked_bank import NxdnAdapter
        return NxdnPipeline(channels=channels, sps=20, n_centuries=4), \
            NxdnAdapter(), synth_nxdn
    if protocol == "dstar":
        from digiham_jax.pipeline import FskPipeline
        from digiham_jax.runtime.tracked_bank import DstarAdapter
        return FskPipeline(channels=channels, protocol="dstar",
                           n_centuries=4), DstarAdapter(), synth_dstar
    if protocol == "pocsag":
        from digiham_jax.pipeline import FskPipeline
        from digiham_jax.runtime.tracked_bank import PocsagAdapter
        return FskPipeline(channels=channels, protocol="pocsag",
                           n_centuries=4), PocsagAdapter(), synth_pocsag
    raise SystemExit(f"unknown protocol {protocol!r}")


def main(protocol: str = "dmr", channels: int = 32, steps: int = 8):
    pipe, adapter, synth = build(protocol, channels)
    decoded = [0]
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: decoded.__setitem__(
            0, decoded[0] + len(d)), adapter=adapter)

    rng = np.random.default_rng(0)
    n_sym = steps * 400 + 200
    samples, sps = synth(channels, n_sym, rng)
    meter = REGISTRY.meter(f"{protocol}_tracked_bank", "samples")
    chunk = 4096
    for lo in range(0, samples.shape[1], chunk):
        block = samples[:, lo:lo + chunk]
        with meter.measure(block.size):
            bank.push(block)
    REGISTRY.report()
    print(f"[{protocol}] decoded {decoded[0]} payload bytes "
          f"across {channels} channels", file=sys.stderr)


if __name__ == "__main__":
    args = sys.argv[1:4]
    proto = args[0] if args else "dmr"
    rest = [int(a) for a in args[1:]]
    main(proto, *rest)
