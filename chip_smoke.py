"""On-card smoke test: the five-protocol decode path on one GPU.

    python chip_smoke.py           # one GPU: phases 0-5 below
    python chip_smoke.py --multi   # four GPUs: the mesh banks only

It drives the system through the entry points a user calls —
``TrackedChannelBank.push``/``flush`` for DMR, YSF, NXDN48, D-Star and
POCSAG, ``DmrPipeline.step_iq``/``step_iq_planes`` for raw IQ, and
``MultiStreamBank`` — at the 256-channel width of BASELINE.json configs[4]
(48 kS/s per channel), and fails hard:

0. device: the card's nvidia-smi line, jax's device kind and count, the
   compile-cache directory, and whether the native host helpers built
   (else their numpy fallback serves);
1. compile: every protocol step at full width; ``memory_analysis()`` of
   the 256-channel ``DmrPipeline.step``;
2. parity on the card: the GPU demod kernel against the plain scan and
   against the per-symbol host oracles, the RRC against its per-sample
   oracle, sync correlation and Viterbi integer-exact;
3. kernel A/B medians (the demod kernel vs the scan, alone and inside
   the DMR step; the banded-matmul RRC vs a plain convolution);
4. end to end: each protocol through ``TrackedChannelBank`` at 256
   channels, one channel in eight keyed with synthesized traffic at
   about 20 dB SNR, the rest noise — every channel's decode, keyed or
   noise, must equal the plain chain's (host RRC + per-symbol demod
   oracle + the symbol-domain reference decoder) bit for bit, up to the
   first frames spent on acquisition;
5. serving: ``MultiStreamBank`` at 256 channels with 2 workers, each
   given its share of the card's memory, byte-identical to one bank.

With ``--multi`` it runs only the checks that exist across cards: a
``TrackedChannelBank(mesh=...)`` over 4 GPUs against the one-card bank
without a mesh, and a ``TimeShardedTrackedBank`` over 4 time shards
against the unsharded bank (one channel in eight keyed, the rest
noise), both byte-identical.

Exits non-zero without a result line when jax finds no GPU (it never
falls back to the CPU) or when the package is missing. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

CHANNELS = 256
CENTURIES = 16
KEY_EVERY = 8          # one keyed channel in eight
SNR_DB = 20.0
AIR_SECONDS = 2.0
RATE = 48000           # samples/s per channel
# this process's share of the card; the serving phase's two workers
# share MULTISTREAM_MEM between them (jax's default is 0.75 for one)
OWN_MEM = "0.5"
MULTISTREAM_MEM = 0.4


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def median_us(fn, *args, n=20):
    """Median wall time of fn(*args) in microseconds: two warm-up calls,
    then n timed calls, each ended by block_until_ready."""
    import jax
    import numpy as np

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


# --------------------------------------------------------------------------
# traffic
# --------------------------------------------------------------------------

def _protocols():
    """name -> (pipeline factory, adapter factory, sps, levels, stream
    factory, decoder factory). Levels map a symbol value to a baseband
    level; streams are the tracked-bank tests' synthesized traffic."""
    import numpy as np

    from digiham_jax.pipeline import (DmrPipeline, FskPipeline,
                                      NxdnPipeline, YsfPipeline)
    from digiham_jax.protocols import pocsag
    from digiham_jax.protocols.dmr import make_decoder as dmr_decoder
    from digiham_jax.protocols.dstar import make_decoder as dstar_decoder
    from digiham_jax.protocols.nxdn import make_decoder as nxdn_decoder
    from digiham_jax.protocols.ysf import make_decoder as ysf_decoder
    from digiham_jax.runtime.tracked_bank import (DstarAdapter,
                                                  NxdnAdapter,
                                                  PocsagAdapter,
                                                  YsfAdapter)
    import test_tracked_bank as dmr_t
    import test_tracked_bank_dstar as dstar_t
    import test_tracked_bank_nxdn as nxdn_t
    import test_tracked_bank_pocsag as pocsag_t
    import test_tracked_bank_ysf as ysf_t

    four = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
    return {
        "dmr": (lambda c, nc: DmrPipeline(channels=c, sps=10,
                                          n_centuries=nc),
                lambda: None, 10, four, dmr_t.make_streams, dmr_decoder),
        "ysf": (lambda c, nc: YsfPipeline(channels=c, sps=10,
                                          n_centuries=nc),
                YsfAdapter, 10, four, ysf_t.make_streams, ysf_decoder),
        "nxdn": (lambda c, nc: NxdnPipeline(channels=c, sps=20,
                                            n_centuries=nc),
                 NxdnAdapter, 20, four, nxdn_t.make_streams, nxdn_decoder),
        "dstar": (lambda c, nc: FskPipeline(channels=c, protocol="dstar",
                                            n_centuries=nc),
                  DstarAdapter, 10, np.array([-1.0, 1.0]),
                  dstar_t.make_streams, dstar_decoder),
        "pocsag": (lambda c, nc: FskPipeline(channels=c,
                                             protocol="pocsag",
                                             n_centuries=nc),
                   PocsagAdapter, 40, np.array([1.0, -1.0]),
                   pocsag_t.make_streams, pocsag.make_decoder),
    }


def keyed_symbols(make_streams, n_symbols: int, seed: int,
                  max_run: int = 24):
    """One channel's transmitted symbols: synthesized traffic segments
    back to back until n_symbols. Runs of one symbol longer than max_run
    (the synthesizers' zero padding) become random symbols: a carrier
    held at one level leaves the receiver's AGC window without a span,
    so no demodulator can slice it, while the symbol-domain reference
    would decode it perfectly."""
    import numpy as np

    parts, total, k = [], 0, 0
    while total < n_symbols:
        s = make_streams(seed * 1000 + k, n_channels=1)[0]
        parts.append(s)
        total += len(s)
        k += 1
    sym = np.concatenate(parts)[:n_symbols].astype(np.uint8)
    n_values = 4 if sym.max() > 1 else 2
    rng = np.random.default_rng(seed)
    start = 0
    for i in range(1, len(sym) + 1):
        if i == len(sym) or sym[i] != sym[start]:
            if i - start > max_run:
                sym[start:i] = rng.integers(0, n_values, i - start)
            start = i
    return sym


def traffic(protocol: str, channels: int, seconds: float, seed: int = 0,
            key_every: int = KEY_EVERY):
    """Baseband samples for a bank: channel c is keyed when
    c % key_every == 0 (synthesized traffic, AWGN at SNR_DB), the others
    carry noise at the same power. Returns
    (samples [C, L] float32, {channel: transmitted symbols})."""
    import numpy as np

    _, _, sps, levels, make_streams, _ = _protocols()[protocol]
    n_sym = int(seconds * RATE) // sps
    amp = 1000.0
    sigma = amp * np.sqrt(np.mean(levels ** 2)) * 10 ** (-SNR_DB / 20)
    rng = np.random.default_rng(seed)
    samples = rng.normal(0.0, sigma, (channels, n_sym * sps))
    tx = {}
    for c in range(0, channels, key_every):
        sym = keyed_symbols(make_streams, n_sym, seed + c)
        tx[c] = sym
        samples[c] += baseband(sym, levels, sps) * amp
    return samples.astype(np.float32), tx


def baseband(symbols, levels, sps: int):
    """Unit-amplitude baseband of a symbol stream. 4FSK: rectangular
    symbols (the receiver's RRC shapes them). 2FSK (D-Star is GMSK): a
    Gaussian pulse, BT = 0.5 — with rectangular pulses the timing
    variance is flat across the symbol and the receiver's +-1 slews
    random-walk into symbol slips."""
    import numpy as np

    wave = np.repeat(levels[symbols], sps)
    if len(levels) != 2:
        return wave
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * 0.5) * sps  # in samples
    t = np.arange(-3 * sps, 3 * sps + 1)
    g = np.exp(-0.5 * (t / sigma) ** 2)
    return np.convolve(wave, g / g.sum(), mode="same")


def reference_decode(protocol: str, symbols):
    """The symbol-domain reference decoder on the transmitted symbols:
    (payload bytes, metadata text)."""
    from digiham_jax.runtime.meta import PipelineMetaWriter

    dec = _protocols()[protocol][5]()
    events = []
    if protocol != "pocsag":  # POCSAG has no metadata stream
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b: events.append(b.decode("utf-8", "surrogateescape"))))
    out = dec.process(symbols)
    return out, "".join(events)


def run_bank(bank, samples, chunk: int):
    for lo in range(0, samples.shape[1], chunk):
        bank.push(samples[:, lo:lo + chunk])
    bank.flush()


def make_bank(protocol: str, channels: int, centuries: int, mesh=None,
              pipeline=None):
    """A TrackedChannelBank collecting per-channel bytes and metadata."""
    from digiham_jax.runtime.meta import PipelineMetaWriter
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank

    factory, adapter, *_ = _protocols()[protocol]
    out = {c: b"" for c in range(channels)}
    bank_cls = TrackedChannelBank
    kw = {} if mesh is None else {"mesh": mesh}
    if pipeline is not None:
        from digiham_jax.runtime.tracked_bank import TimeShardedTrackedBank
        bank_cls, kw = TimeShardedTrackedBank, {}
    bank = bank_cls(pipeline or factory(channels, centuries),
                    on_output=lambda c, d: out.__setitem__(c, out[c] + d),
                    adapter=adapter(), **kw)
    meta = {c: [] for c in range(channels)}
    if protocol != "pocsag":
        for c in range(channels):
            bank.set_meta_writer(c, PipelineMetaWriter(
                lambda b, ev=meta[c]: ev.append(
                    b.decode("utf-8", "surrogateescape"))))
    return bank, out, meta


def oracle_symbols(protocol: str, samples):
    """The plain receive chain on the host for one channel: the
    per-sample RRC (DMR/YSF wide, NXDN narrow, none for the 2FSK modes)
    and the per-symbol demodulator oracle — what the reference's
    rrc_filter | (g)fsk_demodulator pipe produces."""
    from digiham_jax.dsp.demod import FskDemodNp, GfskDemodNp
    from digiham_jax.dsp.rrc import NARROW_RRC, WIDE_RRC, RrcStreamNp

    sps = _protocols()[protocol][2]
    if protocol in ("dstar", "pocsag"):
        return FskDemodNp(sps, invert=protocol == "pocsag",
                          precision="f32").process(samples)
    design = NARROW_RRC if protocol == "nxdn" else WIDE_RRC
    filtered = RrcStreamNp(design).process(samples)
    return GfskDemodNp(sps, precision="f32").process(filtered)


def check_channel(protocol: str, got: bytes, meta: str, samples,
                  tx_symbols=None, allowance: int = 2):
    """One channel's decode, bit-exact against the plain chain: the
    reference decoder on the host oracle's symbols for the same samples
    (empty where that chain decodes nothing — as on most noise
    channels; a false lock on noise must be the oracle chain's too).
    Up to ``allowance`` leading frames may be missing (acquisition), and
    every metadata line must be one the oracle chain emitted. A keyed
    channel (``tx_symbols`` given) must moreover decode something where
    the oracle chain does and emit metadata where it does. Returns
    (expected bytes, missing bytes, whether the decode also equals the
    reference decoder's on the transmitted symbols)."""
    want, want_meta = reference_decode(protocol,
                                       oracle_symbols(protocol, samples))
    keyed = tx_symbols is not None
    assert want.endswith(got), (
        f"{protocol}: decode is not a tail of the oracle chain's "
        f"({len(got)} vs {len(want)} bytes)")
    # a keyed channel whose traffic the oracle chain cannot decode
    # (e.g. D-Star voice with no header) must stay silent too
    assert got or not want or not keyed, (
        f"{protocol}: keyed channel silent, oracle chain decodes "
        f"{len(want)} bytes")
    missing = len(want) - len(got)
    frame = _frame_bytes(protocol)
    assert missing <= allowance * frame, (
        f"{protocol}: {missing} bytes missing, allowance "
        f"{allowance} x {frame}")
    lines = [ln for ln in meta.splitlines() if ln]
    if want_meta and keyed:
        assert lines, f"{protocol}: no metadata lines"
    ref_lines = set(want_meta.splitlines())
    stray = [ln for ln in lines if ln not in ref_lines]
    assert not stray, f"{protocol}: metadata not in reference: {stray[:3]}"
    as_sent = keyed and got == reference_decode(protocol, tx_symbols)[0]
    return len(want), missing, as_sent


def _frame_bytes(protocol: str) -> int:
    """Bytes one frame contributes to the payload stream (the unit of the
    acquisition allowance). POCSAG emits whole messages: one message."""
    return {"dmr": 27, "ysf": 5 * 13, "nxdn": 2 * 18, "dstar": 12,
            "pocsag": 80}[protocol]


def e2e_protocol(protocol: str, channels: int = CHANNELS,
                 seconds: float = AIR_SECONDS, centuries: int = CENTURIES):
    """Phase 4 for one protocol; returns a summary dict."""
    samples, tx = traffic(protocol, channels, seconds,
                          seed=100 * list(_protocols()).index(protocol))
    bank, out, meta = make_bank(protocol, channels, centuries)
    sps = _protocols()[protocol][2]
    t0 = time.perf_counter()
    run_bank(bank, samples, chunk=centuries * 100 * sps)
    wall = time.perf_counter() - t0
    expected = missing = as_sent = 0
    for c, sym in tx.items():
        e, m, a = check_channel(protocol, out[c], "".join(meta[c]),
                                samples[c], sym)
        expected += e
        missing += m
        as_sent += a
    assert expected > 0, f"{protocol}: no keyed channel decoded anything"
    noise = [c for c in out if c not in tx]
    noise_expected = noise_missing = 0
    for c in noise:
        e, m, _ = check_channel(protocol, out[c], "".join(meta[c]),
                                samples[c])
        noise_expected += e
        noise_missing += m
    return {"protocol": protocol, "channels": channels,
            "keyed": len(tx), "air_seconds": seconds,
            "expected_bytes": expected, "missing_bytes": missing,
            "keyed_equal_to_sent": as_sent,
            "noise_channels_checked": len(noise),
            "noise_channel_bytes": sum(len(out[c]) for c in noise),
            "noise_oracle_bytes": noise_expected,
            "noise_missing_bytes": noise_missing, "host_wall_s": wall}


def fm_modulate(samples, deviation_hz: float = 1944.0,
                snr_db: float = SNR_DB, seed: int = 0):
    """Complex baseband FM of baseband audio (peak scaled to the DMR outer
    deviation) with AWGN at snr_db on the unit-amplitude IQ."""
    import numpy as np

    peak = np.abs(samples).max() or 1.0
    freq = samples / peak * deviation_hz
    phase = 2 * np.pi * np.cumsum(freq, axis=1) / RATE
    iq = np.exp(1j * phase)
    rng = np.random.default_rng(seed)
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    iq = iq + sigma * (rng.standard_normal(iq.shape)
                       + 1j * rng.standard_normal(iq.shape))
    return iq.astype(np.complex64)


def e2e_dmr_iq(channels: int = CHANNELS, seconds: float = AIR_SECONDS,
               centuries: int = CENTURIES):
    """Raw IQ through DmrPipeline.step_iq and step_iq_planes against the
    FM-first chain (host discriminator, then the sample path): identical
    symbols, and the keyed channels decode through the tracked bank."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from digiham_jax.dsp.fm import fm_discriminator
    from digiham_jax.pipeline import DmrPipeline

    clean, tx = traffic("dmr", channels, seconds, seed=5)
    iq = fm_modulate(clean, seed=6)
    pipe = DmrPipeline(channels=channels, sps=10, n_centuries=centuries)
    L = centuries * (100 * 10 + 1) + 20
    iq_blk = jnp.asarray(iq[:, :L])
    last = jnp.ones((channels,), jnp.complex64)
    st = pipe.init_state()
    out_iq, _, _ = pipe.step_iq(iq_blk, last, st)
    out_pl, _, _ = pipe.step_iq_planes(iq_blk.real, iq_blk.imag,
                                       last.real, last.imag, st)
    audio, _ = fm_discriminator(iq_blk, last)
    out_fm, _ = pipe.step(audio * 5000.0, st)
    for name, o in (("step_iq", out_iq), ("step_iq_planes", out_pl)):
        np.testing.assert_array_equal(np.asarray(o["dibits"]),
                                      np.asarray(out_fm["dibits"]),
                                      err_msg=name)
    # the whole stream, FM-first, through the tracked bank
    audio_all, _ = jax.jit(fm_discriminator)(jnp.asarray(iq), last)
    samples = np.asarray(audio_all) * np.float32(5000.0)
    bank, out, meta = make_bank("dmr", channels, centuries)
    run_bank(bank, samples, chunk=centuries * 1000)
    for c, sym in tx.items():
        check_channel("dmr", out[c], "".join(meta[c]), samples[c], sym)
    return {"iq_symbols_equal": True, "keyed": len(tx)}


# --------------------------------------------------------------------------
# parity
# --------------------------------------------------------------------------

def demod_parity(channels: int, centuries: int, sps: int, mode: str,
                 invert: bool, clean: bool, interpret: bool = False,
                 oracle_channels: int = 8):
    """The GPU demod kernel against the plain scan over all channels and
    against the per-symbol host oracle on the first oracle_channels.
    Noisy input: >= 99.9% symbol agreement (reduction order may flip a
    knife-edge decision); clean synthesized traffic: exact."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from digiham_jax.dsp.demod import (FskDemodNp, GfskDemodNp,
                                       _demod_block_gpu, _demod_block_xla,
                                       demod_init)
    from digiham_jax.dsp.rrc import WIDE_RRC, RrcState, rrc_filter_block

    L = centuries * (100 * sps + 1) + 2 * sps
    rng = np.random.default_rng(sps * 7 + invert)
    if clean:
        proto = "dmr" if mode == "gfsk" else "dstar"
        _, _, _, levels, make_streams, _ = _protocols()[proto]
        distinct = [keyed_symbols(make_streams, L // sps + 1, c)
                    for c in range(min(channels, 16))]
        sym = np.stack([distinct[c % len(distinct)]
                        for c in range(channels)])
        x = np.stack([baseband(row, levels, sps)[:L] for row in sym])
        x = x * 1000.0
        x = x + rng.normal(0, 1000.0 * 10 ** (-30 / 20), x.shape)
        if mode == "gfsk":
            x, _ = rrc_filter_block(jnp.asarray(x, jnp.float32),
                                    RrcState.init(channels), WIDE_RRC)
        x = np.asarray(x, np.float32)
    else:
        x = (rng.standard_normal((channels, L)) * 1000).astype(np.float32)
    st = demod_init(channels)
    gpu = jax.jit(lambda x, st: _demod_block_gpu(
        x, st, centuries, sps, mode, invert, interpret=interpret))
    a, sa = gpu(jnp.asarray(x), st)
    b, sb = _demod_block_xla(jnp.asarray(x), st, centuries, sps, mode,
                             invert)
    a, b = np.asarray(a), np.asarray(b)
    agree = float((a == b).mean())
    need = 1.0 if clean else 0.999
    assert agree >= need, (sps, mode, invert, clean, agree)
    if clean:
        np.testing.assert_array_equal(np.asarray(sa.pos), np.asarray(sb.pos))
    oracle_agree = []
    for c in range(min(oracle_channels, channels)):
        o = (GfskDemodNp(sps, precision="f32") if mode == "gfsk"
             else FskDemodNp(sps, invert=invert, precision="f32"))
        want = o.process(x[c])[:a.shape[1]]
        oracle_agree.append(float((a[c, :len(want)] == want).mean()))
    worst = min(oracle_agree)
    assert worst >= need, (sps, mode, invert, clean, oracle_agree)
    return agree, worst


def rrc_parity(channels: int = CHANNELS, T: int = 16384,
               oracle_channels: int = 2, oracle_len: int = 2048):
    """The banded-matmul RRC on the card against the per-sample oracle
    (rrc_filter_np): max |diff| <= 1e-5 * max |y| at HIGHEST precision
    (TF32 would miss this by two orders of magnitude)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from digiham_jax.dsp.rrc import (NARROW_RRC, WIDE_RRC, RrcState,
                                     rrc_filter_block, rrc_filter_np)

    rng = np.random.default_rng(3)
    worst = 0.0
    for design in (WIDE_RRC, NARROW_RRC):
        x = rng.normal(0, 1000, (channels, T)).astype(np.float32)
        y, _ = jax.jit(lambda x: rrc_filter_block(
            x, RrcState.init(channels, design), design))(jnp.asarray(x))
        y = np.asarray(y)
        for c in range(oracle_channels):
            want = rrc_filter_np(x[c, :oracle_len], design)
            err = np.abs(y[c, :oracle_len] - want).max() / np.abs(want).max()
            assert err <= 1e-5, (design.name, c, err)
            worst = max(worst, float(err))
    return worst


def integer_parity(channels: int = CHANNELS):
    """Sync correlation and Viterbi: integer-exact against numpy."""
    import jax.numpy as jnp
    import numpy as np

    from digiham_jax.fec.viterbi import (conv_encode, viterbi_decode,
                                         viterbi_decode_np)
    from digiham_jax.pipeline.dmr import _SYNC_PATTERNS, dmr_sync_correlate

    rng = np.random.default_rng(9)
    d = rng.integers(0, 4, (channels, 1600)).astype(np.uint8)
    got = np.asarray(dmr_sync_correlate(jnp.asarray(d)))
    K = _SYNC_PATTERNS.shape[1]
    win = np.lib.stride_tricks.sliding_window_view(d.astype(np.int64), K,
                                                   axis=1)
    x = win[:, :, None, :] ^ _SYNC_PATTERNS[None, None]
    want = ((x & 1) + ((x >> 1) & 1)).sum(-1)
    np.testing.assert_array_equal(got, want)

    bits = rng.integers(0, 2, (channels * 2, 100))
    obs = conv_encode(bits, 16)
    flips = rng.random(obs.shape) < 0.1
    obs = np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs)
    for blocked in (0, 4):
        gb, gm = viterbi_decode(jnp.asarray(obs), 16, blocked)
        wb, wm = viterbi_decode_np(obs, 16, blocked)
        np.testing.assert_array_equal(np.asarray(gb), wb)
        np.testing.assert_array_equal(np.asarray(gm), wm)
    return True


# --------------------------------------------------------------------------
# A/B
# --------------------------------------------------------------------------

def _conv_rrc(x, design):
    """The plain-convolution RRC the banded matmul replaced, kept here
    only as the A/B's other arm."""
    import jax
    import jax.numpy as jnp

    taps = jnp.asarray(design.scaled_taps)
    xh = jnp.concatenate(
        [jnp.zeros((x.shape[0], design.ntaps - 1), x.dtype), x], axis=-1)
    return jax.lax.conv_general_dilated(
        xh[:, None, :], taps[None, None, :], (1,), "VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)[:, 0, :]


def kernel_ab(channels: int = CHANNELS, centuries: int = CENTURIES):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from digiham_jax.dsp.demod import (_demod_block_gpu, _demod_block_xla,
                                       demod_init)
    from digiham_jax.dsp.rrc import (NARROW_RRC, WIDE_RRC, RrcState,
                                     rrc_filter_block)
    from digiham_jax.pipeline import DmrPipeline

    rng = np.random.default_rng(1)
    res = {}
    st = demod_init(channels)
    for sps in (10, 20, 40):
        L = centuries * (100 * sps + 1) + 2 * sps
        x = jnp.asarray(rng.normal(0, 1000, (channels, L)), jnp.float32)
        k = jax.jit(lambda x, st, sps=sps: _demod_block_gpu(
            x, st, centuries, sps, "gfsk", False))
        s = jax.jit(lambda x, st, sps=sps: _demod_block_xla(
            x, st, centuries, sps, "gfsk", False))
        res[f"demod_sps{sps}"] = {"kernel_us": median_us(k, x, st),
                                  "scan_us": median_us(s, x, st)}
    pipe = DmrPipeline(channels=channels, sps=10, n_centuries=centuries)
    L = centuries * (100 * 10 + 1) + 20
    x = jnp.asarray(rng.normal(0, 1000, (channels, L)), jnp.float32)
    ps = pipe.init_state()
    res["dmr_step"] = {
        "kernel_us": median_us(lambda x, s: pipe.step(x, s), x, ps),
        "scan_us": median_us(lambda x, s: pipe.step(x, s, impl="xla"),
                             x, ps)}
    x = jnp.asarray(rng.normal(0, 1000, (channels, 16384)), jnp.float32)
    for design in (WIDE_RRC, NARROW_RRC):
        st0 = RrcState.init(channels, design)
        mm = jax.jit(lambda x, s, d=design: rrc_filter_block(x, s, d)[0])
        cv = jax.jit(lambda x, d=design: _conv_rrc(x, d))
        res[f"rrc_{design.ntaps}taps"] = {
            "matmul_us": median_us(mm, x, st0),
            "conv_us": median_us(cv, x)}
    return res


# --------------------------------------------------------------------------
# serving and mesh
# --------------------------------------------------------------------------

def serving_parity(channels: int = CHANNELS, seconds: float = 1.0,
                   centuries: int = CENTURIES):
    """MultiStreamBank with 2 workers (channels/2 each) against one bank
    in this process: byte-identical per-channel output. The bank's
    budget of the card's memory, MULTISTREAM_MEM, goes in the
    environment just before the bank is built (this process's own client
    has long started with OWN_MEM); each worker gets half of it."""
    from digiham_jax.runtime.multistream import MultiStreamBank

    samples, tx = traffic("dmr", channels, seconds, seed=21)
    chunk = centuries * 1000
    bank, ref, _ = make_bank("dmr", channels, centuries)
    run_bank(bank, samples, chunk)
    got = {c: b"" for c in range(channels)}
    key = "XLA_PYTHON_CLIENT_MEM_FRACTION"
    own = os.environ.get(key)
    os.environ[key] = str(MULTISTREAM_MEM)
    try:
        ms = MultiStreamBank("dmr", channels=channels, n_procs=2,
                             on_output=lambda c, d: got.__setitem__(
                                 c, got[c] + bytes(d)),
                             pipeline_kwargs={"n_centuries": centuries})
    finally:
        if own is None:
            del os.environ[key]
        else:
            os.environ[key] = own
    with ms:
        for lo in range(0, samples.shape[1], chunk):
            ms.push(samples[:, lo:lo + chunk])
        ms.flush()
    assert got == ref, [c for c in got if got[c] != ref[c]]
    assert all(ref[c] for c in tx)
    return {"channels": channels, "workers": 2,
            "worker_mem_fraction": ms.worker_mem_fraction,
            "bytes": sum(len(v) for v in ref.values())}


def mesh_parity(devices, channels: int = CHANNELS, seconds: float = 1.0,
                centuries: int = CENTURIES):
    """TrackedChannelBank(mesh) over all devices (it steps the
    GSPMD-partitionable plain path) against the one-card bank users run
    without a mesh (the demod kernel on a GPU): byte- and event-identical."""
    from digiham_jax.parallel import make_mesh

    samples, tx = traffic("dmr", channels, seconds, seed=31)
    mesh = make_mesh(n_channel_shards=len(devices), n_time_shards=1,
                     devices=devices)
    results = []
    for m in (None, mesh):
        bank, out, meta = make_bank("dmr", channels, centuries, mesh=m)
        run_bank(bank, samples, centuries * 1000)
        results.append((out, {c: "".join(v) for c, v in meta.items()}))
    assert results[0] == results[1]
    assert all(results[0][0][c] for c in tx)
    return {"channels": channels, "devices": len(devices)}


def timesharded_parity(devices, channels: int = 64, seconds: float = 6.5,
                       cps: int = 36):
    """TimeShardedTrackedBank over len(devices) time shards against the
    unsharded bank on the same stream, one channel in eight keyed and
    the rest noise, over at least two sharded steps: the idle channels'
    timing random-walks away from the keyed ones' (the carried per-
    channel origins absorb it), and every byte and event is identical."""
    from digiham_jax.parallel import make_mesh
    from digiham_jax.parallel.streaming import TimeShardedPipeline

    mesh = make_mesh(n_channel_shards=1, n_time_shards=len(devices),
                     devices=devices)
    sp = TimeShardedPipeline(mesh, channels=channels, protocol="dmr",
                             centuries_per_shard=cps)
    samples, tx = traffic("dmr", channels, seconds, seed=41)
    assert samples.shape[1] > 2 * sp.block_len + sp.h_left + sp.h_right
    results = []
    for sharded in (False, True):
        bank, out, meta = (make_bank("dmr", channels, 4, pipeline=sp)
                           if sharded else make_bank("dmr", channels, 4))
        run_bank(bank, samples, 8192)
        results.append((out, {c: "".join(m) for c, m in meta.items()}))
    assert results[0] == results[1]
    assert all(results[0][0][c] for c in tx)
    return {"channels": channels, "keyed": len(tx),
            "time_shards": len(devices),
            "sharded_steps": samples.shape[1] // sp.block_len}


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh checks")
    args = ap.parse_args(argv)
    if not __debug__:
        print("chip_smoke: its checks are asserts; run without -O",
              file=sys.stderr)
        return 1
    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION",
                          "0.9" if args.multi else OWN_MEM)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (jax found {dev.platform}); "
              f"refusing to run on the CPU", file=sys.stderr)
        return 1
    want = 4 if args.multi else 1
    if args.multi and len(devices) < want:
        print(f"chip_smoke --multi: needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    import digiham_jax  # noqa: F401  (fails here outside the repo)
    from digiham_jax.utils import enable_compilation_cache

    cache = enable_compilation_cache()
    from digiham_jax import native

    log("card:", card_line())
    log(f"jax: {dev.platform} {dev.device_kind} x{len(devices)}; "
        f"compile cache {cache}; native host helpers: "
        f"{'built' if native._load() is not None else 'numpy fallback'}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devices) if args.multi else 1}

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        log(f"[{name}] {time.perf_counter() - t0:.1f}s {json.dumps(r)}")
        return r

    if args.multi:
        devs = devices[:4]
        phase("mesh bank x4", mesh_parity, devs)
        phase("time-sharded bank x4", timesharded_parity, devs)
    else:
        phase("compile", compile_all)
        for sps in (10, 20, 40):
            for mode, invert in (("gfsk", False), ("fsk", False),
                                 ("fsk", True)):
                for clean in (False, True):
                    phase(f"demod parity sps={sps} {mode} inv={invert} "
                          f"{'clean' if clean else 'noise'}",
                          demod_parity, CHANNELS, CENTURIES, sps, mode,
                          invert, clean)
        phase("rrc parity", rrc_parity)
        phase("integer parity", integer_parity)
        log("card:", card_line())
        phase("kernel A/B", kernel_ab)
        for protocol in ("dmr", "ysf", "nxdn", "dstar", "pocsag"):
            phase(f"e2e {protocol}", e2e_protocol, protocol)
        phase("e2e dmr raw IQ", e2e_dmr_iq)
        log("peak_bytes_in_use:", dev.memory_stats()["peak_bytes_in_use"])
        phase("serving", serving_parity)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def compile_all(channels: int = CHANNELS, centuries: int = CENTURIES):
    """Compile and run every protocol step once at full width; print the
    DMR step's memory analysis."""
    import jax
    import jax.numpy as jnp

    res = {}
    for name, (factory, *_rest) in _protocols().items():
        sps = _rest[1]
        pipe = factory(channels, centuries)
        L = centuries * (100 * sps + 1) + 2 * sps
        x = jnp.zeros((channels, L), jnp.float32)
        st = pipe.init_state()
        t0 = time.perf_counter()
        jax.block_until_ready(pipe.step(x, st))
        res[name] = time.perf_counter() - t0
        if name == "dmr":
            step = jax.jit(lambda x, s: pipe.step(x, s))
            ma = step.lower(x, st).compile().memory_analysis()
            log("dmr step memory_analysis:", ma)
    return {"first_call_s": res}


if __name__ == "__main__":
    sys.exit(main())
