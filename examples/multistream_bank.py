"""Production serving example: MultiStreamBank — N worker processes,
each owning a channel shard with its OWN device client session.

Why this driver exists: a worker can be lost and respawned without
touching the others, and one worker's host control-plane work overlaps
the others' device steps. On one GPU each worker gets its share of the
card's memory (runtime/multistream.py). The sharded bank is
byte-identical to one TrackedChannelBank (channels are independent), and
snapshot()/restore() compose per-worker blobs so mid-stream
checkpointing still works.

Usage: python examples/multistream_bank.py [channels] [n_procs]
       (synthesizes DMR voice on every channel; runs on CPU or GPU)
"""
import sys
import time

import numpy as np

sys.path.insert(0, "tests")  # TX-side frame synthesizers double as examples

FOUR_LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0


def main(channels: int = 8, n_procs: int = 2):
    from digiham_jax.runtime.multistream import MultiStreamBank
    from digiham_jax.protocols.dmr.phases import pack_dibits
    from dmr_synth import voice_frame

    rng = np.random.default_rng(7)
    payloads, rows = [], []
    for c in range(channels):
        payload = rng.integers(0, 4, 108).astype(np.uint8)
        payloads.append(pack_dibits(payload))
        frames = [voice_frame(s % 2, payload, sync=True) for s in range(12)]
        dib = np.concatenate([np.zeros(30, np.uint8)] + frames)
        rows.append(np.repeat(FOUR_LEVELS[dib], 10) * 1000)
    samples = np.stack(rows).astype(np.float32)

    decoded = {c: b"" for c in range(channels)}
    t0 = time.perf_counter()
    with MultiStreamBank("dmr", channels=channels, n_procs=n_procs,
                         on_output=lambda c, d: decoded.__setitem__(
                             c, decoded[c] + d),
                         pipeline_kwargs={"n_centuries": 2}) as bank:
        # mid-stream checkpoint: the composite blob restores into a
        # fresh bank (even a different process topology is rejected
        # loudly rather than silently mis-sharded)
        half = samples.shape[1] // 2 // 8192 * 8192
        for lo in range(0, half, 8192):
            bank.push(samples[:, lo:lo + 8192])
        blob = bank.snapshot()
        print(f"checkpoint: {len(blob)} bytes across {n_procs} shards")
        for lo in range(half, samples.shape[1], 8192):
            bank.push(samples[:, lo:lo + 8192])
    wall = time.perf_counter() - t0

    ok = sum(payloads[c] in decoded[c] for c in range(channels))
    print(f"{ok}/{channels} channels decoded their TX payload "
          f"({n_procs} worker processes, {wall:.1f}s wall)")
    return 0 if ok == channels else 1


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:3])))
