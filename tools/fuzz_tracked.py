"""Tracked-bank equivalence fuzzing against the compiled reference.

Random structured/corrupted D-Star and POCSAG bit streams are decoded by
(a) the reference binary (tests/ref_harness) and (b) the
TrackedChannelBank adapters on the device-gated hunting path, with the
per-block gate computed exactly like the production pipelines (dense
sync correlation + the adapter's thresholds, here via numpy popcount so
the campaign doesn't pay a jit recompile per ragged chunk width).
Payloads — and for D-Star, metadata event streams — must match
byte-for-byte. Divergent streams are dumped to /tmp/fuzz_tracked_div_*.

Usage: python tools/fuzz_tracked.py [n_cases] [seed0]
"""
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

# host-side campaign: pin jax to CPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

HARNESS = os.path.join("tests", "ref_harness", "ref_harness")


_POP4 = np.array([0, 1, 1, 2])  # popcount of a dibit XOR


def np_sync_dist(symbols: np.ndarray, pattern: np.ndarray,
                 dibits: bool = False) -> np.ndarray:
    """[C, T] symbols -> [C, T-len+1] hamming distances (numpy sliding).
    For dibit protocols the distance is popcount-of-XOR per symbol
    (src/lib/hamming_distance.c semantics), not the XOR sum."""
    w = np.lib.stride_tricks.sliding_window_view(symbols, len(pattern),
                                                 axis=-1)
    x = w ^ pattern
    return (_POP4[x] if dibits else x).sum(-1)


def run_reference(protocol, bits):
    meta = f"/tmp/fuzz_tracked_meta_{os.getpid()}.txt"
    p = subprocess.run([HARNESS, protocol, meta],
                       input=bits.astype(np.uint8).tobytes(),
                       capture_output=True, timeout=120)
    assert p.returncode == 0, p.stderr[-300:]
    with open(meta, encoding="utf-8", errors="surrogateescape") as f:
        return p.stdout, f.read()


def _setup(protocol):
    """-> (pipeline, adapter, gate_fn) for one channel; gate_fn maps a
    [1, T] symbol block to the same outputs-dict the device pipeline
    would feed adapter.block_hits."""
    from digiham_jax.pipeline import (DmrPipeline, FskPipeline,
                                      NxdnPipeline, YsfPipeline)
    from digiham_jax.runtime import tracked_bank as tb

    if protocol == "dstar":
        from digiham_jax.protocols.dstar.phases import (HEADER_SYNC,
                                                        VOICE_SYNC)
        return (FskPipeline(channels=1, protocol="dstar", n_centuries=2),
                tb.DstarAdapter(),
                lambda blk: {
                    "sync_dist_header_sync": np_sync_dist(blk, HEADER_SYNC),
                    "sync_dist_voice_sync": np_sync_dist(blk, VOICE_SYNC)})
    if protocol == "pocsag":
        from digiham_jax.protocols.pocsag import SYNC_PATTERN
        return (FskPipeline(channels=1, protocol="pocsag", n_centuries=2),
                tb.PocsagAdapter(),
                lambda blk: {
                    "sync_dist_preamble": np_sync_dist(blk, SYNC_PATTERN)})
    if protocol == "dmr":
        from digiham_jax.protocols.dmr.phases import (BS_DATA_SYNC,
                                                      BS_VOICE_SYNC,
                                                      MS_DATA_SYNC,
                                                      MS_VOICE_SYNC)
        pats = [BS_DATA_SYNC, BS_VOICE_SYNC, MS_DATA_SYNC, MS_VOICE_SYNC]
        return (DmrPipeline(channels=1, sps=10, n_centuries=2),
                tb.DmrAdapter(),
                lambda blk: {"sync_dist_dense": np.stack(
                    [np_sync_dist(blk, p, dibits=True) for p in pats],
                    axis=-1)})
    if protocol == "ysf":
        from digiham_jax.protocols.ysf.phases import YSF_SYNC
        return (YsfPipeline(channels=1, sps=10, n_centuries=10),
                tb.YsfAdapter(),
                lambda blk: {"sync_dist_dense":
                             np_sync_dist(blk, YSF_SYNC, dibits=True)})
    if protocol == "nxdn":
        from digiham_jax.protocols.nxdn.phases import FRAME_SYNC
        return (NxdnPipeline(channels=1, sps=20, n_centuries=4),
                tb.NxdnAdapter(),
                lambda blk: {"sync_dist_dense":
                             np_sync_dist(blk, FRAME_SYNC, dibits=True)})
    raise ValueError(protocol)


def run_tracked(protocol, symbols, chunk, rng, snapshot_at=None):
    """Optionally snapshot+restore into a brand-new bank before chunk
    index ``snapshot_at`` — the resumed decode must still match the
    reference byte-for-byte (checkpoint x gated-hunting interaction)."""
    from digiham_jax.runtime.meta import PipelineMetaWriter
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank

    pipe, adapter, gate_fn = _setup(protocol)
    out = {0: b""}
    events = []

    def make_bank():
        b = TrackedChannelBank(
            pipe, on_output=lambda c, d: out.__setitem__(0, out[0] + d),
            adapter=adapter)
        b.set_meta_writer(0, PipelineMetaWriter(
            lambda x: events.append(x.decode("utf-8", "surrogateescape"))))
        return b

    bank = make_bank()
    streams = symbols[None, :]
    for i, lo in enumerate(range(0, streams.shape[1], chunk)):
        if snapshot_at is not None and i == snapshot_at:
            blob = bank.snapshot()
            bank = make_bank()
            bank.restore(blob)
        blk = streams[:, lo:lo + chunk].astype(np.uint8)
        if blk.shape[1] > 40:
            hits = adapter.block_hits(gate_fn(blk))
            bank._consume_dibits(blk, hits)
        else:
            bank.push_dibits(blk)
    return out[0], "".join(events)


def synth_dstar(rng):
    from test_dstar import (bit_sync_preamble, full_voice_stream,
                            make_header_bytes, voice_frame)

    from digiham_jax.protocols.dstar.header import encode_header
    from digiham_jax.protocols.dstar.phases import (HEADER_SYNC,
                                                    TERMINATOR,
                                                    VOICE_SYNC)

    parts = [rng.integers(0, 2, int(rng.integers(30, 500)))]
    for _ in range(int(rng.integers(1, 4))):
        mode = rng.integers(0, 4)
        if mode == 0:
            parts += full_voice_stream(int(rng.integers(3, 50)))
        elif mode == 1:
            parts += [bit_sync_preamble(), VOICE_SYNC]
            parts += [voice_frame(raw_data24=VOICE_SYNC) if i % 21 == 20
                      else voice_frame(
                          voice9=rng.integers(0, 256, 9)
                          .astype(np.uint8).tobytes(),
                          data3=rng.integers(0, 256, 3)
                          .astype(np.uint8).tobytes())
                      for i in range(int(rng.integers(3, 45)))]
        elif mode == 2:
            parts += [bit_sync_preamble(), HEADER_SYNC,
                      encode_header(make_header_bytes(
                          voice=bool(rng.integers(0, 2))))]
        else:
            parts += full_voice_stream(int(rng.integers(3, 12)))
            parts.append(np.concatenate([
                np.unpackbits(rng.integers(0, 256, 9).astype(np.uint8),
                              bitorder="little"), TERMINATOR]))
        parts.append(rng.integers(0, 2, int(rng.integers(20, 300))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def synth_pocsag(rng):
    from test_pocsag import (address_codeword, alpha_payloads,
                             build_stream, data_codeword)

    from digiham_jax.protocols import pocsag

    parts = [rng.integers(0, 2, int(rng.integers(30, 400)))]
    for _ in range(int(rng.integers(1, 4))):
        cws = []
        for _ in range(int(rng.integers(1, 20))):
            k = rng.integers(0, 4)
            if k == 0:
                cws.append(address_codeword(int(rng.integers(0, 1 << 18)),
                                            int(rng.integers(0, 4))))
            elif k == 1:
                cws.append(data_codeword(int(rng.integers(0, 1 << 20))))
            elif k == 2:
                cws.append(pocsag.IDLE_CODEWORD)
            else:
                text = "".join(chr(32 + int(x)) for x in
                               rng.integers(0, 95, int(rng.integers(1, 30))))
                cws += [data_codeword(p) for p in alpha_payloads(text)]
        parts.append(build_stream(
            cws, preamble_bits=int(rng.integers(1, 4)) * 32))
        parts.append(rng.integers(0, 2, int(rng.integers(10, 200))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def synth_dibit(protocol, rng):
    """Structured dibit streams for DMR/YSF/NXDN, reusing the tracked-bank
    test synthesizers (single channel)."""
    seed = int(rng.integers(0, 1 << 31))
    if protocol == "dmr":
        import test_tracked_bank as m
    elif protocol == "ysf":
        import test_tracked_bank_ysf as m
    else:
        import test_tracked_bank_nxdn as m
    return m.make_streams(seed, n_channels=1)[0]


def corrupt(rng, bits):
    r = rng.random()
    bits = bits.copy()
    if r < 0.45:
        idx = rng.random(len(bits)) < rng.uniform(0.001, 0.03)
        bits[idx] ^= 1
    elif r < 0.6:
        cut = rng.integers(0, len(bits), 2)
        bits = np.delete(bits, np.arange(
            min(cut), min(max(cut), min(cut) + 500)))
    return bits


PROTOCOLS = ("dstar", "pocsag", "dmr", "ysf", "nxdn")
META_CHECKED = ("dstar", "dmr", "ysf", "nxdn")


def main(n_cases=200, seed0=0):
    bad = 0
    for i in range(n_cases):
        rng = np.random.default_rng(seed0 + i)
        proto = PROTOCOLS[i % len(PROTOCOLS)]
        if proto == "dstar":
            symbols = corrupt(rng, synth_dstar(rng))
        elif proto == "pocsag":
            symbols = corrupt(rng, synth_pocsag(rng))
        else:
            symbols = synth_dibit(proto, rng)  # corruption built in
        chunk = int(rng.integers(97, 4096))
        n_chunks = max(1, -(-len(symbols) // chunk))
        snapshot_at = (int(rng.integers(1, n_chunks + 1))
                       if rng.random() < 0.5 else None)
        got, meta = run_tracked(proto, symbols, chunk, rng, snapshot_at)
        ref, ref_meta = run_reference(proto, symbols)
        meta_eq = meta == ref_meta if proto in META_CHECKED else True
        if got != ref or not meta_eq:
            bad += 1
            np.save(f"/tmp/fuzz_tracked_div_{proto}_{seed0 + i}.npy",
                    symbols)
            print(f"DIVERGENCE {proto} seed={seed0 + i} chunk={chunk} "
                  f"got={len(got)} ref={len(ref)} meta_eq={meta_eq}")
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{n_cases} cases, {bad} divergences",
                  flush=True)
    print(f"DONE {n_cases} cases, {bad} divergences")
    return bad


if __name__ == "__main__":
    sys.exit(1 if main(*(int(a) for a in sys.argv[1:3])) else 0)
