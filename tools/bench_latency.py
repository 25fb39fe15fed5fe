"""End-to-end streaming latency: ingest -> voice-frame-out vs block size.

The reference's implicit contract is real-time streaming into OpenWebRX
(reference examples/dmr-decoder.sh:13-29: 48 kS/s discriminator audio in,
AMBE frames out, per-sample loops so latency ~= one frame of buffering).
Our device pipeline trades per-sample dispatch for century-blocked
batching, which ADDS buffering latency. This tool measures it end to end:

  For every DMR voice frame emitted by a production streaming driver,
    algo_latency = (samples ingested when the frame surfaced)
                 - (stream index of the frame's last sample)
  i.e. how much MORE signal had to arrive after the frame ended before
  the driver handed its 27 voice bytes to on_output. Reported in ms of
  air time at 48 kS/s (sps=10 x 4800 symbols/s), together with the
  wall-clock push cost, for a sweep of (driver, n_centuries, block size).

Frames self-identify: each synthesized voice burst carries a unique
random 108-dibit payload, and the emitted bytes are matched against
pack_dibits(payload) so latency is computed per frame with no ordering
assumptions (reference voice passthrough: dmr_phase.cpp voice payload ->
stdout unchanged).

Drivers covered (VERDICT r3 item 4):
  streamdriver  runtime/stream.py StreamDriver  (symbols out, demod only)
  tracked       runtime/tracked_bank.py TrackedChannelBank (full stack)
  timesharded   TimeShardedTrackedBank over a (channel, time) mesh

Usage: python tools/bench_latency.py          (pins jax to CPU)
       LAT_HW=1 python tools/bench_latency.py (the default jax backend,
                                               e.g. the GPU)
Prints one JSON line per configuration; paste into docs/LATENCY.md.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

HW = os.environ.get("LAT_HW", "") == "1"
if not HW:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax  # noqa: E402

if not HW:
    jax.config.update("jax_platforms", "cpu")

LEVELS = np.array([1.0, 3.0, -1.0, -3.0], np.float32) / 3.0
SPS = 10
RATE = 4800 * SPS            # samples/s per channel
SAMPLES_PER_MS = RATE / 1000.0


def synth_stream(seed, n_bursts=5, frames_per_burst=8, tail=2000):
    """One channel of dibits: dotting gaps + voice bursts with unique
    payloads. Returns (dibits, {voice_bytes: end_dibit_index}) where the
    map holds SLOT-0 frames only — the tracker forwards voice from one
    active slot at a time (reference dmr_phase.cpp active-slot gate), so
    slot-1 bursts in the same stream never reach on_output."""
    from digiham_jax.protocols.dmr.phases import pack_dibits
    from dmr_synth import voice_frame

    rng = np.random.default_rng(seed)
    parts, ends = [], {}
    pos = 0
    for _ in range(n_bursts):
        # dotting-pattern gap (alternating +-1/3): keeps the demod's
        # variance timing recovery locked between bursts so decode is
        # deterministic and every frame can be matched exactly (random
        # dibit gaps cause timing wander -> symbol errors at burst start).
        # The gap MUST be a whole EVEN number of 144-dibit frames: a
        # repeater's TDMA grid (frame boundaries AND slot alternation) is
        # continuous, and the tracker (faithful reference hysteresis)
        # keeps its grid through short gaps — EMB false-positives on
        # off-grid data resurrect sync_count, so a burst that lands off
        # the old grid is swallowed entirely, and an odd-frame gap flips
        # slot parity so the high-stability tracker rejects the next
        # burst's TACT (dmr_phase.cpp slot_stability >= 5). Gap lengths
        # mix short (tracker stays locked, decay < 6 frames) and long
        # (sync lost -> SyncPhase re-hunt) to cover both paths.
        gap_frames = 2 * int(rng.integers(2, 7))
        gap = np.tile(np.array([0, 2], np.uint8), 72 * gap_frames)
        parts.append(gap)
        pos += len(gap)
        for s in range(frames_per_burst):
            payload = rng.integers(0, 4, 108).astype(np.uint8)
            fr = voice_frame(s % 2, payload, sync=True)
            parts.append(fr)
            pos += len(fr)
            if s % 2 == 0:  # slot 0 = the active voice slot
                ends[pack_dibits(payload)] = pos - 1  # frame's last dibit
    # tail long enough that the most-buffered config under test still
    # decodes the final burst without flush (tracked nc=16 buffers ~16k
    # samples; timesharded buffers shards*cps*100*sps — pass a bigger tail)
    parts.append(np.tile(np.array([0, 2], np.uint8), tail // 2))
    return np.concatenate(parts), ends


def modulate(dibits):
    return np.repeat(LEVELS[dibits], SPS) * 1000.0


def _percentiles(xs):
    if not xs:
        return {"p50": None, "p99": None, "max": None, "n": 0}
    a = np.asarray(xs, np.float64)
    return {"p50": round(float(np.percentile(a, 50)), 3),
            "p99": round(float(np.percentile(a, 99)), 3),
            "max": round(float(a.max()), 3), "n": len(xs)}


def drive(make_bank, samples_per_chan, ends_per_chan, block):
    """Push `block`-sample chunks; collect per-frame latency (samples)
    and per-push wall seconds. Emission mapping is exact: emitted voice
    bytes are looked up in the synth's payload->end-index map."""
    emitted = []          # (latency_samples)
    pushed = [0]

    def on_output(c, voice):
        # tolerant matching: the first frame of a burst picks up a couple
        # of symbol errors from RRC ISI while timing settles (physical,
        # reference does the same) — accept <=16 flipped bits of 216.
        # Trailing sync-loss-hysteresis emissions (dotting payload,
        # ~90-110 bits off) stay unmatched by a wide margin.
        v = bytes(voice)
        ends = ends_per_chan[c]
        end = ends.pop(v, None)
        if end is None:
            for k in list(ends):
                if sum((a ^ b).bit_count() for a, b in zip(v, k)) <= 16:
                    end = ends.pop(k)
                    break
        if end is not None:
            emitted.append(pushed[0] - ((end + 1) * SPS))

    bank = make_bank(on_output)
    n = samples_per_chan.shape[1]
    walls = []
    for lo in range(0, n, block):
        chunk = samples_per_chan[:, lo:lo + block]
        pushed[0] = lo + chunk.shape[1]
        t0 = time.perf_counter()
        bank.push(chunk)
        walls.append(time.perf_counter() - t0)
    unmatched = sum(len(e) for e in ends_per_chan)
    if hasattr(bank, "close"):  # MultiStreamBank owns worker processes
        bank.close()
    return emitted, walls, unmatched


def bench_tracked(channels, n_centuries, block, mesh=None, cps=None,
                  tail=2000):
    from digiham_jax.pipeline import DmrPipeline
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank

    streams = [synth_stream(1000 + c, tail=tail) for c in range(channels)]
    # pad every channel to the longest stream with dotting (never truncate:
    # cutting a short channel's tail below the bank's buffered block size
    # strands its final burst unprocessed — observed as nc=16 tail misses)
    n = max(len(s[0]) for s in streams)
    dots = np.tile(np.array([0, 2], np.uint8), (n + 1) // 2)
    samples = np.stack([
        modulate(np.concatenate([s[0], dots[:n - len(s[0])]]))
        for s in streams])
    ends = [dict(s[1]) for s in streams]

    if cps is not None:
        from digiham_jax.parallel.streaming import TimeShardedPipeline
        from digiham_jax.runtime.tracked_bank import TimeShardedTrackedBank
        sp = TimeShardedPipeline(mesh, channels=channels, protocol="dmr",
                                 centuries_per_shard=cps)
        make = lambda cb: TimeShardedTrackedBank(sp, on_output=cb)
    else:
        make = lambda cb: TrackedChannelBank(
            DmrPipeline(channels=channels, sps=SPS,
                        n_centuries=n_centuries), on_output=cb)
    # warmup on a short prefix so compile time stays out of the walls
    w_ends = [dict(s[1]) for s in streams]
    drive(make, samples[:, :min(n * SPS, 80_000)], w_ends, block)
    return drive(make, samples, ends, block)


def bench_multistream(channels, n_procs, n_centuries, block, tail=2000):
    """The multi-process serving point: MultiStreamBank — per-push wall
    = the slowest worker's device step + gather (workers run
    concurrently, so under saturation this measures the queueing)."""
    from digiham_jax.runtime.multistream import MultiStreamBank

    streams = [synth_stream(3000 + c, tail=tail) for c in range(channels)]
    n = max(len(s[0]) for s in streams)
    dots = np.tile(np.array([0, 2], np.uint8), (n + 1) // 2)
    samples = np.stack([
        modulate(np.concatenate([s[0], dots[:n - len(s[0])]]))
        for s in streams])
    ends = [dict(s[1]) for s in streams]

    make = lambda cb: MultiStreamBank(
        "dmr", channels=channels, n_procs=n_procs, on_output=cb,
        pipeline_kwargs={"n_centuries": n_centuries, "sps": SPS})
    w_ends = [dict(s[1]) for s in streams]
    drive(make, samples[:, :min(n * SPS, 80_000)], w_ends, block)
    return drive(make, samples, ends, block)


def bench_streamdriver(block, n_centuries=1):
    """Demod-only: latency from sample ingest to SYMBOL availability."""
    import functools

    from digiham_jax.dsp.demod import demod_init, gfsk_demod_block
    from digiham_jax.runtime.stream import StreamDriver

    dib, _ = synth_stream(7)
    samples = modulate(dib)[None, :]
    drv = StreamDriver(1, SPS, functools.partial(gfsk_demod_block),
                       demod_init(1), n_centuries=n_centuries)
    lat, walls = [], []
    emitted_symbols = 0
    for lo in range(0, samples.shape[1], block):
        chunk = samples[:, lo:lo + block]
        t0 = time.perf_counter()
        blocks = drv.push(chunk)
        walls.append(time.perf_counter() - t0)
        pushed = lo + chunk.shape[1]
        for b in blocks:
            emitted_symbols += np.asarray(b).shape[1]
            # the newest emitted symbol's last sample is ~symbol*SPS
            lat.append(pushed - emitted_symbols * SPS)
    return lat, walls


def row(name, block, lat_samples, walls, extra=None, missed=0):
    lat_ms = [max(0.0, x) / SAMPLES_PER_MS for x in lat_samples]
    wall_ms = [w * 1000 for w in walls]
    out = {"driver": name, "block": block,
           "block_ms": round(block / SAMPLES_PER_MS, 2),
           "algo_latency_ms": _percentiles(lat_ms),
           "push_wall_ms": _percentiles(wall_ms),
           "frames_matched": len(lat_samples), "frames_missed": missed,
           "backend": jax.default_backend()}
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def main():
    rows = []
    # StreamDriver (demod only) — CPU + HW
    for block in (1024, 4800, 16384):
        lat, walls = bench_streamdriver(block)
        rows.append(row("streamdriver[nc=1]", block, lat, walls))

    # TrackedChannelBank: n_centuries x block sweep
    for nc in (2, 4, 16):
        for block in (1024, 4800, 16384):
            lat, walls, missed = bench_tracked(2, nc, block)
            rows.append(row(f"tracked[nc={nc}]", block, lat, walls,
                            missed=missed))

    # MultiStreamBank at the serving operating point (nc=16, block=16k,
    # 8 workers) — LAT_MULTISTREAM=0 skips (it spawns 8 jax processes)
    if os.environ.get("LAT_MULTISTREAM", "1") != "0":
        lat, walls, missed = bench_multistream(8, 8, 16, 16384)
        rows.append(row("multistream[nc=16,procs=8]", 16384, lat, walls,
                        missed=missed,
                        extra={"channels": 8, "n_procs": 8}))

    if not HW and len(jax.devices()) >= 4:
        from digiham_jax.parallel import make_mesh
        mesh = make_mesh(n_channel_shards=2, n_time_shards=2)
        for cps, block in ((36, 16384), (36, 65536)):
            # 2 time shards x 36 centuries x 1000 samples buffered:
            # the tail must outlast ~72k samples (7,200 dibits)
            lat, walls, missed = bench_tracked(
                2, None, block, mesh=mesh, cps=cps, tail=16000)
            rows.append(row(f"timesharded[cps={cps},mesh=2x2]", block,
                            lat, walls, missed=missed))
    return rows


if __name__ == "__main__":
    main()
