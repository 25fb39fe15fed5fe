"""Fuzz the time-sharded tracker bank against the unsharded bank.

Random streams (voice bursts, noise gaps, corruption, optional clock
skew, random chunking, optional mid-stream snapshot/restore) through
TimeShardedTrackedBank on the virtual (channel, time) mesh vs the
unsharded TrackedChannelBank: bytes and metadata events must be
identical. The unsharded bank is itself continuously fuzzed against
the compiled reference binaries (tools/fuzz_tracked.py), so equality
here chains the time-sharded production path to the reference.

Each case picks a random protocol (all five) unless FUZZ_PROTO pins
one. Usage: python tools/fuzz_timesharded.py [n_cases] [seed0]
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

from digiham_jax.parallel import make_mesh  # noqa: E402
from digiham_jax.utils import enable_compilation_cache  # noqa: E402
from digiham_jax.parallel.streaming import TimeShardedPipeline  # noqa: E402
from digiham_jax.pipeline import (DmrPipeline, FskPipeline,  # noqa: E402
                                  NxdnPipeline, YsfPipeline)
from digiham_jax.runtime.meta import PipelineMetaWriter  # noqa: E402
from digiham_jax.runtime.tracked_bank import (  # noqa: E402
    DstarAdapter, NxdnAdapter, PocsagAdapter, TimeShardedTrackedBank,
    TrackedChannelBank, YsfAdapter)
from dmr_synth import voice_frame  # noqa: E402

enable_compilation_cache()
LEV = np.array([1.0, 3.0, -1.0, -3.0]) / 3
C = 2


def _dmr_dibits(rng):
    parts = [rng.integers(0, 4, int(rng.integers(20, 400)))]
    payload = rng.integers(0, 4, 108)
    for burst in range(int(rng.integers(1, 4))):
        n_frames = int(rng.integers(30, 120))
        parts += [voice_frame(s % 2, payload, sync=True)
                  for s in range(n_frames)]
        parts.append(rng.integers(0, 4, int(rng.integers(50, 600))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _ysf_dibits(rng):
    from ysf_synth import header_frame, terminator_frame, vd2_frame
    parts = [rng.integers(0, 4, int(rng.integers(20, 300))),
             header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  ")]
    for i in range(int(rng.integers(18, 40))):
        parts.append(vd2_frame(i % 8, b"FUZZTSHYSF"))
    parts.append(terminator_frame())
    parts.append(rng.integers(0, 4, int(rng.integers(50, 400))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _nxdn_dibits(rng):
    from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                            vcall_superframe_bytes, voice_slot_dibits)
    units = vcall_superframe_bytes(int(rng.integers(0, 8)),
                                   int(rng.integers(1, 1 << 16)),
                                   int(rng.integers(1, 1 << 16)))
    payload = rng.integers(0, 4, 72).astype(np.uint8)
    parts = [rng.integers(0, 4, int(rng.integers(20, 300)))]
    for i in range(int(rng.integers(16, 34))):
        slots = [voice_slot_dibits(payload, 38),
                 voice_slot_dibits(payload, 38 + 72)]
        parts.append(nxdn_frame((0b01, 0b10, 0b11),
                                encode_sacch_unit(i % 4, units[i % 4]),
                                slots))
    parts.append(np.zeros(300, np.uint8))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _dstar_bits(rng):
    from test_dstar import full_voice_stream
    parts = full_voice_stream(int(rng.integers(80, 200)))
    parts.append(np.zeros(400, np.uint8))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _pocsag_bits(rng):
    from test_pocsag import (address_codeword, alpha_payloads,
                             build_stream, data_codeword)
    parts = [np.zeros(100, np.uint8)]
    for m in range(int(rng.integers(5, 12))):
        cws = [address_codeword(int(rng.integers(1, 1 << 18)), 3)]
        cws += [data_codeword(p)
                for p in alpha_payloads(f"FZ {m}")]
        parts.append(build_stream(cws))
        parts.append(np.zeros(int(rng.integers(60, 200)), np.uint8))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


# protocol -> (symbol synth, levels lookup, sps, plain-pipe, adapter)
PROTOS = {
    "dmr": (_dmr_dibits, LEV, 10,
            lambda: DmrPipeline(channels=C, sps=10, n_centuries=4), None),
    "ysf": (_ysf_dibits, LEV, 10,
            lambda: YsfPipeline(channels=C, sps=10, n_centuries=5),
            YsfAdapter),
    "nxdn": (_nxdn_dibits, LEV, 20,
             lambda: NxdnPipeline(channels=C, sps=20, n_centuries=3),
             NxdnAdapter),
    "dstar": (_dstar_bits, np.array([-1.0, 1.0]), 10,
              lambda: FskPipeline(channels=C, protocol="dstar",
                                  n_centuries=2), DstarAdapter),
    "pocsag": (_pocsag_bits, np.array([1.0, -1.0]), 40,
               lambda: FskPipeline(channels=C, protocol="pocsag",
                                   n_centuries=2), PocsagAdapter),
}


def make_samples(rng, proto):
    synth, lev, sps, _, _ = PROTOS[proto]
    dibits = synth(rng)
    if rng.random() < 0.4:  # sparse symbol corruption
        nsym = int(lev.shape[0])
        idx = rng.random(dibits.size) < 0.005
        dibits = dibits.copy()
        dibits[idx] = rng.integers(0, nsym, int(idx.sum()))
    base = np.repeat(lev[dibits], sps) * 1000
    noise = rng.uniform(20, 70)
    samples = np.stack([base + rng.normal(0, noise, base.shape)
                        for _ in range(C)]).astype(np.float32)
    if rng.random() < 0.5:  # clock skew up to 120 ppm
        skew = rng.uniform(-1.2e-4, 1.2e-4)
        n = samples.shape[1]
        t = np.arange(int(n / (1 + abs(skew)))) * (1 + skew)
        t = np.clip(t, 0, n - 1)
        samples = np.stack([np.interp(t, np.arange(n), samples[c])
                            for c in range(C)]).astype(np.float32)
    return samples


def make_banks(mesh, proto):
    _, _, sps, plain_pipe, adapter_cls = PROTOS[proto]
    adapter = adapter_cls() if adapter_cls else None
    sp = TimeShardedPipeline(mesh, channels=C, protocol=proto)
    out_s = {c: b"" for c in range(C)}
    bank_s = TimeShardedTrackedBank(
        sp, adapter=adapter_cls() if adapter_cls else None,
        on_output=lambda c, d: out_s.__setitem__(c, out_s[c] + d))
    out_p = {c: b"" for c in range(C)}
    bank_p = TrackedChannelBank(
        plain_pipe(), adapter=adapter,
        on_output=lambda c, d: out_p.__setitem__(c, out_p[c] + d))
    metas = {"s": [], "p": []}
    for tag, bank in (("s", bank_s), ("p", bank_p)):
        for c in range(C):
            ev = []
            bank.set_meta_writer(c, PipelineMetaWriter(
                lambda b, e=ev: e.append(b.decode())))
            metas[tag].append(ev)
    return bank_s, bank_p, out_s, out_p, metas


def main(n_cases=100, seed0=0):
    mesh = make_mesh(n_channel_shards=2, n_time_shards=2)
    pin = os.environ.get("FUZZ_PROTO")
    names = [pin] if pin else list(PROTOS)
    bad = 0
    for i in range(n_cases):
        rng = np.random.default_rng(seed0 + i)
        proto = names[int(rng.integers(0, len(names)))]
        samples = make_samples(rng, proto)
        bank_s, bank_p, out_s, out_p, metas = make_banks(mesh, proto)
        chunk = int(rng.integers(2048, 16384))
        snap_at = (int(rng.integers(1, samples.shape[1]))
                   if rng.random() < 0.25 else None)
        fed = 0
        for lo in range(0, samples.shape[1], chunk):
            blk = samples[:, lo:lo + chunk]
            bank_s.push(blk)
            bank_p.push(blk)
            fed += blk.shape[1]
            if snap_at is not None and fed >= snap_at:
                bank_s.restore(bank_s.snapshot())  # must be a no-op
                snap_at = None
        bank_s.flush()
        bank_p.flush()
        ok = all(out_s[c] == out_p[c] for c in range(C)) and all(
            "".join(metas["s"][c]) == "".join(metas["p"][c])
            for c in range(C))
        if not ok:
            bad += 1
            np.save(f"/tmp/fuzz_tsh_div_{seed0 + i}.npy", samples)
            print(f"DIVERGENCE proto={proto} seed={seed0 + i} "
                  f"chunk={chunk}")
        if (i + 1) % 10 == 0:
            jax.clear_caches()
            print(f"{i + 1}/{n_cases} cases, {bad} divergences",
                  flush=True)
    print(f"DONE {n_cases} cases, {bad} divergences")
    return bad


if __name__ == "__main__":
    sys.exit(1 if main(*(int(a) for a in sys.argv[1:3])) else 0)
