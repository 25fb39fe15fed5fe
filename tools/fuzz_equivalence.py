"""Deep equivalence fuzzing against the compiled reference.

Runs many random and corrupted-signal streams through both the reference
harness and digiham_jax's decoders, comparing payload + metadata
byte-for-byte. Any divergence is dumped to /tmp/fuzz_div_* for replay.

Usage: python tools/fuzz_equivalence.py [seeds_per_case]
"""
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, "tests")

HARNESS = os.path.join("tests", "ref_harness", "ref_harness")


def run_reference(protocol, symbols):
    meta = f"/tmp/fuzz_meta_{os.getpid()}.txt"
    p = subprocess.run([HARNESS, protocol, meta],
                       input=symbols.astype(np.uint8).tobytes(),
                       capture_output=True, timeout=120)
    assert p.returncode == 0, p.stderr[-300:]
    with open(meta) as f:
        return p.stdout, f.read()


def run_ours(protocol, symbols, chunker=None):
    """chunker: optional rng; feeds the decoder in random-size chunks to
    exercise the streaming carry logic (the reference is fed all at once
    — outputs must be identical either way)."""
    from digiham_jax.runtime.meta import PipelineMetaWriter
    makers = {
        "dmr": "digiham_jax.protocols.dmr",
        "ysf": "digiham_jax.protocols.ysf",
        "nxdn": "digiham_jax.protocols.nxdn",
        "dstar": "digiham_jax.protocols.dstar",
        "pocsag": "digiham_jax.protocols.pocsag",
    }
    import importlib
    mod = importlib.import_module(makers[protocol])
    events = []
    dec = mod.make_decoder()
    dec.set_meta_writer(PipelineMetaWriter(lambda b: events.append(b.decode())))
    symbols = symbols.astype(np.uint8)
    if chunker is None:
        out = dec.process(symbols)
    else:
        parts = []
        pos = 0
        while pos < len(symbols):
            n = int(chunker.integers(1, 2000))
            parts.append(dec.process(symbols[pos:pos + n]))
            pos += n
        out = b"".join(parts)
    return out, "".join(events)


def structured_stream(protocol, rng):
    if protocol == "dmr":
        from dmr_synth import voice_frame, data_frame, group_lc, \
            voice_superframe
        lc = group_lc(int(rng.integers(1, 1 << 24)),
                      int(rng.integers(1, 1 << 24)))
        payload = rng.integers(0, 4, 108)
        parts = []
        for _ in range(int(rng.integers(2, 5))):
            kind = rng.integers(0, 3)
            if kind == 0:
                parts += [voice_frame(s % 2, payload, sync=True)
                          for s in range(int(rng.integers(2, 8)))]
            elif kind == 1:
                parts += [data_frame(s % 2, int(rng.integers(0, 11)), lc)
                          for s in range(int(rng.integers(2, 6)))]
            else:
                parts += voice_superframe(int(rng.integers(0, 2)), lc,
                                          payload)
        return np.concatenate(parts)
    if protocol == "ysf":
        from ysf_synth import vd2_frame, header_frame, terminator_frame
        parts = [header_frame(b"AAA", b"BBB", b"CCC", b"DDD")]
        parts += [vd2_frame(int(rng.integers(0, 8)), b"FUZZFUZZ  ")
                  for _ in range(int(rng.integers(2, 7)))]
        parts.append(terminator_frame())
        return np.concatenate(parts)
    if protocol == "nxdn":
        from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                                vcall_superframe_bytes, voice_slot_dibits)
        units = vcall_superframe_bytes(int(rng.integers(0, 8)),
                                       int(rng.integers(0, 1 << 16)),
                                       int(rng.integers(0, 1 << 16)))
        payload = rng.integers(0, 4, 72).astype(np.uint8)
        parts = [nxdn_frame((0b01, 0b10, int(rng.integers(0, 4))),
                            encode_sacch_unit(i, units[i]),
                            [voice_slot_dibits(payload, 38),
                             voice_slot_dibits(payload, 110)])
                 for i in range(4)]
        return np.concatenate(parts + [np.zeros(250, np.uint8)])
    if protocol == "dstar":
        from test_dstar import full_voice_stream
        return np.concatenate(full_voice_stream(int(rng.integers(5, 30)))
                              + [np.zeros(250, np.uint8)])
    if protocol == "pocsag":
        from test_pocsag import (IDLE_CODEWORD, address_codeword,
                                 alpha_payloads, build_stream, data_codeword)
        text = "".join(chr(int(rng.integers(32, 127)))
                       for _ in range(int(rng.integers(1, 30))))
        cws = [address_codeword(int(rng.integers(0, 1 << 18)),
                                int(rng.integers(0, 4)))]
        cws.extend(data_codeword(p) for p in alpha_payloads(text))
        cws.append(IDLE_CODEWORD)
        return build_stream(cws)
    raise ValueError(protocol)


def main():
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    nsym = {"dmr": 4, "ysf": 4, "nxdn": 4, "dstar": 2, "pocsag": 2}
    failures = 0
    total = 0
    for protocol in ("dmr", "ysf", "nxdn", "dstar", "pocsag"):
        for seed in range(seeds):
            rng = np.random.default_rng(seed * 7919 + hash(protocol) % 1000)
            for mode in ("noise", "structured", "corrupted"):
                if mode == "noise":
                    stream = rng.integers(
                        0, nsym[protocol], 25000).astype(np.uint8)
                else:
                    stream = structured_stream(protocol, rng).astype(np.uint8)
                    if mode == "corrupted":
                        rate = rng.choice([0.002, 0.01, 0.05, 0.15])
                        idx = rng.random(len(stream)) < rate
                        stream = stream.copy()
                        stream[idx] = rng.integers(
                            0, nsym[protocol], int(idx.sum()))
                total += 1
                ref = run_reference(protocol, stream)
                chunker = (np.random.default_rng(seed + 1) if seed % 2
                           else None)
                ours = run_ours(protocol, stream, chunker)
                if ref != ours:
                    failures += 1
                    path = f"/tmp/fuzz_div_{protocol}_{seed}_{mode}.npy"
                    np.save(path, stream)
                    print(f"DIVERGENCE {protocol} seed={seed} mode={mode} "
                          f"-> {path}")
                    print(f"  ref payload {len(ref[0])}B "
                          f"ours {len(ours[0])}B")
                    if ref[1] != ours[1]:
                        for a, b in zip(ref[1].splitlines(),
                                        ours[1].splitlines()):
                            if a != b:
                                print(f"  REF : {a}\n  OURS: {b}")
                                break
        print(f"{protocol}: done")
    print(f"{total} cases, {failures} divergences")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
