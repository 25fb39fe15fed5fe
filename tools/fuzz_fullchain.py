"""Sample-domain full-chain fuzzing against the compiled reference.

The strongest composition check: random RF-like sample streams (AWGN,
amplitude steps, trackable clock drift, zero tails) decoded by

  reference:  dsp_harness gfsk/fsk  ->  ref_harness <protocol>
  ours:       fused device pipeline ->  TrackedChannelBank

and compared byte-for-byte (payload + metadata). Streams end with a
RANDOM (possibly zero) padding and the bank is flush()ed — EOF behavior
is part of the contract. Both sides get the
SAME filtered audio (for DMR the reference's own RRC binary feeds both,
since our float32 conv differs by ~1e-5 — enough to flip a borderline
noisy symbol; the demodulators themselves are symbol-exact on identical
input, so the full chain must match exactly).

Usage: python tools/fuzz_fullchain.py [n_cases] [seed0]
"""
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

DSP = os.path.join("tests", "ref_harness", "dsp_harness")
REF = os.path.join("tests", "ref_harness", "ref_harness")

FOUR_LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
TWO_LEVELS = np.array([-1.0, 1.0])


def ref_chain(demod_args, protocol, samples):
    p1 = subprocess.run([DSP] + demod_args,
                        input=samples.astype(np.float32).tobytes(),
                        capture_output=True, timeout=300)
    assert p1.returncode == 0, p1.stderr[-200:]
    meta = f"/tmp/fuzz_fullchain_meta_{os.getpid()}.txt"
    p2 = subprocess.run([REF, protocol, meta], input=p1.stdout,
                        capture_output=True, timeout=300)
    assert p2.returncode == 0, p2.stderr[-200:]
    with open(meta, encoding="utf-8", errors="surrogateescape") as f:
        return p2.stdout, f.read()


def our_chain(protocol, samples, chunk):
    from digiham_jax.pipeline import (DmrPipeline, FskPipeline,
                                      NxdnPipeline, YsfPipeline)
    from digiham_jax.runtime.meta import PipelineMetaWriter
    from digiham_jax.runtime.tracked_bank import (DstarAdapter,
                                                  DmrAdapter,
                                                  NxdnAdapter,
                                                  PocsagAdapter,
                                                  TrackedChannelBank,
                                                  YsfAdapter)

    if protocol == "dmr":
        pipe = DmrPipeline(channels=1, sps=10, n_centuries=2,
                           use_rrc=False)
        adapter = DmrAdapter()
    elif protocol == "ysf":
        pipe = YsfPipeline(channels=1, sps=10, n_centuries=10,
                           use_rrc=False)
        adapter = YsfAdapter()
    elif protocol == "nxdn":
        pipe = NxdnPipeline(channels=1, sps=20, n_centuries=4,
                            use_rrc=False)
        adapter = NxdnAdapter()
    elif protocol == "dstar":
        pipe = FskPipeline(channels=1, protocol="dstar", n_centuries=2)
        adapter = DstarAdapter()
    else:
        pipe = FskPipeline(channels=1, protocol="pocsag", n_centuries=2)
        adapter = PocsagAdapter()
    out = {0: b""}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: out.__setitem__(0, out[0] + d),
        adapter=adapter)
    events = []
    bank.set_meta_writer(0, PipelineMetaWriter(
        lambda b: events.append(b.decode("utf-8", "surrogateescape"))))
    row = samples[None, :].astype(np.float32)
    for lo in range(0, row.shape[1], chunk):
        bank.push(row[:, lo:lo + chunk])
    bank.flush()  # reference-exact EOF draining -> no padding needed
    return out[0], "".join(events)


def impair(rng, samples, sps):
    """AWGN + amplitude step + optional trackable clock drift."""
    amp = rng.uniform(300, 3000)
    x = samples * amp
    if rng.random() < 0.5:
        # amplitude step mid-stream (AGC must re-converge)
        k = rng.integers(len(x) // 4, 3 * len(x) // 4)
        x = x.copy()
        x[k:] *= rng.uniform(0.4, 2.0)
    x = x + rng.normal(0, amp * rng.uniform(0.0, 0.15), len(x))
    if rng.random() < 0.4:
        # trackable clock offset: <= 1 sample per 100 symbols
        period = int(rng.integers(150 * sps, 400 * sps))
        keep = np.ones(len(x), bool)
        keep[::period] = False
        x = x[keep]
    return x.astype(np.float32)


def synth(protocol, rng):
    if protocol == "dmr":
        from dmr_synth import data_frame, group_lc, voice_superframe
        lc = group_lc(int(rng.integers(1, 1 << 24)),
                      int(rng.integers(1, 1 << 24)))
        payload = rng.integers(0, 4, 108)
        parts = [rng.integers(0, 4, int(rng.integers(30, 150)))]
        parts += [data_frame(s % 2, 1, lc) for s in range(2)]
        for k in range(int(rng.integers(1, 4))):
            parts += voice_superframe(k % 2, lc, payload)
        dibits = np.concatenate(parts)
        base = np.repeat(FOUR_LEVELS[dibits], 10)
        pad = int(rng.integers(0, 6000))
        return np.concatenate([base, np.zeros(pad * 10)]), 10
    if protocol == "dstar":
        from test_dstar import full_voice_stream
        bits = np.concatenate(
            full_voice_stream(int(rng.integers(5, 40))))
        base = np.repeat(TWO_LEVELS[bits.astype(int)], 10)
        pad = int(rng.integers(0, 12000))
        return np.concatenate([base, np.zeros(pad * 10)]), 10
    if protocol == "ysf":
        from ysf_synth import (header_frame, terminator_frame, v1_frame,
                               vd2_frame, vw_frame)
        parts = [rng.integers(0, 4, int(rng.integers(30, 100))),
                 header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  ")]
        for _ in range(int(rng.integers(2, 6))):
            k = rng.integers(0, 3)
            fn = int(rng.integers(0, 8))
            parts.append(vd2_frame(fn, b"FULLCHAIN ") if k == 0
                         else v1_frame(fn) if k == 1 else vw_frame(fn))
        parts.append(terminator_frame())
        dibits = np.concatenate([np.asarray(q, np.uint8) for q in parts])
        base = np.repeat(FOUR_LEVELS[dibits], 10)
        pad = int(rng.integers(0, 10000))
        return np.concatenate([base, np.zeros(pad * 10)]), 10
    if protocol == "nxdn":
        from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                                vcall_superframe_bytes,
                                voice_slot_dibits)
        units = vcall_superframe_bytes(1, int(rng.integers(1, 1 << 16)),
                                       int(rng.integers(1, 1 << 16)))
        payload72 = rng.integers(0, 4, 72).astype(np.uint8)
        parts = [rng.integers(0, 4, int(rng.integers(30, 100)))]
        for i in range(int(rng.integers(4, 9))):
            parts.append(nxdn_frame(
                (0b01, 0b10, 0b11),
                encode_sacch_unit(i % 4, units[i % 4]),
                [voice_slot_dibits(payload72, 38),
                 voice_slot_dibits(payload72, 110)]))
        dibits = np.concatenate([np.asarray(q, np.uint8) for q in parts])
        base = np.repeat(FOUR_LEVELS[dibits], 20)
        pad = int(rng.integers(0, 4000))
        return np.concatenate([base, np.zeros(pad * 20)]), 20
    from test_pocsag import (address_codeword, alpha_payloads,
                             build_stream, data_codeword)
    text = "".join(chr(65 + int(c)) for c in rng.integers(0, 26, 10))
    cws = [address_codeword(int(rng.integers(1, 1 << 18)), 3)]
    cws += [data_codeword(p) for p in alpha_payloads(text)]
    bits = build_stream(cws)
    base = np.repeat(-TWO_LEVELS[bits.astype(int)], 40)  # inverted
    pad = int(rng.integers(0, 3000))
    return np.concatenate([base, np.zeros(pad * 40)]), 40


def is_precision_tie(proto, samples):
    """True when the divergence is a float-precision tie-break, not a
    logic bug. Two axes, both inherent to a float32 device kernel:

    1. timing loop: the reference uses C doubles
       (fsk_demodulator.cpp:55-66); if the f64 and f32 per-symbol
       oracles disagree anywhere, a timing tie cascaded.
    2. slicer margin: XLA's f32 reduction order can differ from the
       reference's sequential f32 sums by ~1 ulp; at a slicer boundary
       that flips exactly one symbol (no feedback, no cascade). The
       device replay must differ from the reference demod ONLY at
       symbols whose slicer margin is within float rounding.

    Observed ~0.1% of heavy-impairment streams; zero events in all
    symbol-domain fuzzing and the golden DSP suite."""
    from digiham_jax.dsp.demod import FskDemodNp, GfskDemodNp
    sps = {"dmr": 10, "ysf": 10, "nxdn": 20, "dstar": 10,
           "pocsag": 40}[proto]
    if proto in ("dstar", "pocsag"):
        mk = lambda prec: FskDemodNp(sps, invert=(proto == "pocsag"),
                                     precision=prec)
    else:
        mk = lambda prec: GfskDemodNp(sps, precision=prec)
    a = mk("f64").process(samples)
    b = mk("f32").process(samples)
    n = min(len(a), len(b))
    if bool((a[:n] != b[:n]).any()):
        return True  # timing-loop tie (f32 vs the reference's doubles)

    # Second precision axis: the device kernel's f32 REDUCTION ORDER can
    # differ from the reference's sequential f32 sums by ~1 ulp; at a
    # slicer boundary that flips exactly one symbol (slicing has no
    # feedback, so no cascade). Replay the device kernel, diff against
    # the reference demod binary, and require every differing symbol to
    # sit within float rounding of a slicer threshold.
    import subprocess

    import jax.numpy as jnp

    from digiham_jax.dsp.demod import demod_init, fsk_demod_block, \
        gfsk_demod_block
    from digiham_jax.runtime.stream import SampleBuffer

    ref = np.frombuffer(subprocess.run(
        [DSP] + DEMOD_ARGS[proto],
        input=samples.astype(np.float32).tobytes(),
        capture_output=True, timeout=300).stdout, np.uint8)
    st = demod_init(1)
    sb = SampleBuffer(1)
    sb.push(samples[None, :].astype(np.float32))
    need = 2 * (100 * sps + 1) + 2
    dev = []
    while True:
        pos = int(np.asarray(st.pos).max())
        if sb.fill < pos + need:
            break
        block = jnp.asarray(sb.view(pos + need))
        if proto in ("dstar", "pocsag"):
            sym, st = fsk_demod_block(block, st, 2, sps,
                                      proto == "pocsag")
        else:
            sym, st = gfsk_demod_block(block, st, 2, sps)
        dev.append(np.asarray(sym)[0])
        base = int(np.asarray(st.pos).min())
        if base:
            sb.consume(base)
            st.pos = st.pos - base
    dev = np.concatenate(dev) if dev else np.zeros(0, np.uint8)
    m = min(len(dev), len(ref))
    where = np.nonzero(dev[:m] != ref[:m])[0]
    if not len(where):
        return False

    probe = mk("f32")
    margins = {}
    idx = [0]
    targets = set(int(w) for w in where)
    orig = type(probe)._slice

    def sl(o, average, vmin, vmax, center):
        if idx[0] in targets:
            scale = max(abs(float(average)), abs(float(vmax)), 1.0)
            edges = [center]
            if hasattr(o, "invert") is False or True:
                pass
            if type(o).__name__ == "GfskDemodNp":
                umid = (vmax - center) * np.float32(0.625) + center
                lmid = (vmin - center) * np.float32(0.625) + center
                edges += [umid, lmid]
            margins[idx[0]] = min(
                abs(float(average) - float(e)) for e in edges) / scale
        idx[0] += 1
        return orig(o, average, vmin, vmax, center)

    type(probe)._slice = sl
    try:
        probe.process(samples)
    finally:
        type(probe)._slice = orig
    if all(margins.get(w, 1.0) < 1e-5 for w in targets):
        return True

    # Final, mechanism-agnostic arbiter: a float tie is a knife edge —
    # nudge the amplitude by ±1e-4 and a true tie vanishes (both chains
    # agree again), while a logic bug diverges robustly. (This also
    # catches ~1-ulp reduction-order differences inside the TIMING
    # decision, which cascade and defeat the margin probe.)
    for eps in (1.0 + 1e-4, 1.0 - 1e-4):
        xs = (samples * np.float32(eps)).astype(np.float32)
        got, _ = our_chain(proto, xs, 8192)
        ref_out, _ = ref_chain(DEMOD_ARGS[proto], proto, xs)
        if got == ref_out:
            return True
    return False


PROTOCOLS = ("dmr", "dstar", "pocsag", "ysf", "nxdn")
DEMOD_ARGS = {"dmr": ["gfsk", "10"], "dstar": ["fsk", "10"],
              "pocsag": ["fsk", "40", "i"], "ysf": ["gfsk", "10"],
              "nxdn": ["gfsk", "20"]}


def main(n_cases=60, seed0=0):
    bad = 0
    ties = 0
    for i in range(n_cases):
        rng = np.random.default_rng(seed0 + i)
        proto = PROTOCOLS[i % len(PROTOCOLS)]
        clean, sps = synth(proto, rng)
        samples = impair(rng, clean, sps)
        if proto in ("dmr", "ysf", "nxdn"):
            # feed the reference's own RRC output to BOTH chains
            # (nxdn uses the narrow 6.25 kHz design, nxdn48-decoder.sh)
            rrc_mode = "rrc-narrow" if proto == "nxdn" else "rrc"
            p = subprocess.run([DSP, rrc_mode],
                               input=samples.tobytes(),
                               capture_output=True, timeout=300)
            assert p.returncode == 0
            samples = np.frombuffer(p.stdout, np.float32)
        chunk = int(rng.integers(4096, 32768))
        got, meta = our_chain(proto, samples, chunk)
        ref, ref_meta = ref_chain(DEMOD_ARGS[proto], proto, samples)
        meta_eq = meta == ref_meta if proto != "pocsag" else True
        if got != ref or not meta_eq:
            if is_precision_tie(proto, samples):
                ties += 1
                print(f"PRECISION_TIE {proto} seed={seed0 + i} "
                      f"(float-precision knife edge, not logic)")
            else:
                bad += 1
                np.save(
                    f"/tmp/fuzz_fullchain_div_{proto}_{seed0 + i}.npy",
                    samples)
                print(f"DIVERGENCE {proto} seed={seed0 + i} "
                      f"got={len(got)} ref={len(ref)} meta_eq={meta_eq}")
        if (i + 1) % 20 == 0:
            # every case builds fresh pipeline instances whose jitted
            # steps are cached per (instance, block-shape); clear
            # periodically or a long campaign exhausts LLVM code memory
            jax.clear_caches()
        if (i + 1) % 30 == 0:
            print(f"{i + 1}/{n_cases} cases, {bad} divergences",
                  flush=True)
    print(f"DONE {n_cases} cases, {bad} divergences, "
          f"{ties} precision ties")
    return bad


if __name__ == "__main__":
    sys.exit(1 if main(*(int(a) for a in sys.argv[1:3])) else 0)
