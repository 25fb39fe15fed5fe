"""Host control-plane capacity: real-time channels per core, per protocol.

Drives the PRODUCTION TrackedChannelBank push loop (hunt + decode
rounds + trackers + metadata) single-channel over structured synthetic
traffic (the oracle-fuzz generators — transmissions separated by noise
gaps, so acquisition hunting is included) and reports host-side wall time
with the device ``decode_fields`` calls timed and subtracted — i.e. the
per-core cost of the host control plane when the field decode runs on
the GPU. Also reports the isolated steady-state per-frame tracking cost
(field_row + process_fields) for DMR.

Usage: python tools/bench_host_tracking.py   (pins jax to CPU)
Prints one JSON line per protocol + one DMR detail line.
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _streams():
    """(name, bits/dibits stream, symbol_rate) triples, ~clean traffic."""
    sys.path.insert(0, "tools")
    import fuzz_tracked as ft  # pins jax to CPU at import

    rng = np.random.default_rng(12345)
    out = []
    for name in ("dmr", "ysf", "nxdn"):
        parts = [ft.synth_dibit(name, rng) for _ in range(6)]
        rate = 2400 if name == "nxdn" else 4800
        out.append((name, np.concatenate(parts), rate))
    out.append(("dstar",
                np.concatenate([ft.synth_dstar(rng) for _ in range(6)]),
                4800))
    out.append(("pocsag",
                np.concatenate([ft.synth_pocsag(rng) for _ in range(6)]),
                1200))
    return out


def bench_bank(name, stream, rate):
    import jax
    import jax.numpy  # noqa: F401
    from digiham_jax.pipeline import (DmrPipeline, FskPipeline,
                                      NxdnPipeline, YsfPipeline)
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank

    if name == "dmr":
        pipe = DmrPipeline(channels=1, sps=10, n_centuries=2)
    elif name == "ysf":
        pipe = YsfPipeline(channels=1, sps=10, n_centuries=5)
    elif name == "nxdn":
        pipe = NxdnPipeline(channels=1, sps=20, n_centuries=2)
    else:
        pipe = FskPipeline(channels=1, protocol=name, n_centuries=2)
    bank = TrackedChannelBank(pipe, on_output=lambda c, d: None)
    dev = [0.0]
    orig = bank.adapter.decode_fields

    def timed(frames, jnp_, **kw):
        t0 = time.perf_counter()
        r = orig(frames, jnp_, **kw)
        dev[0] += time.perf_counter() - t0
        return r

    bank.adapter.decode_fields = timed
    chunk = 800
    # warm: first quarter absorbs the jit compiles, then reset clocks
    warm_end = len(stream) // 4
    for lo in range(0, warm_end, chunk):
        bank.push_dibits(stream[None, lo:lo + chunk])
    dev[0] = 0.0
    t0 = time.perf_counter()
    for lo in range(warm_end, len(stream) - chunk, chunk):
        bank.push_dibits(stream[None, lo:lo + chunk])
    wall = time.perf_counter() - t0
    host = wall - dev[0]
    n_sym = (len(stream) - chunk - warm_end) // chunk * chunk
    air_seconds = n_sym / rate
    return {
        "metric": f"{name}_host_control_plane",
        # dibit-path banks get no device sync gating, so this includes
        # full host hunting over the streams' noise gaps — the
        # worst-case host cost; production sample-path banks gate
        # hunting on the device correlation (_fast_skip)
        "includes_acquisition_no_device_gating": True,
        "host_seconds_per_air_second": round(host / air_seconds, 6),
        "realtime_channels_per_core": round(air_seconds / host),
        "device_decode_seconds_subtracted": round(dev[0], 4),
        "symbols": int(n_sym),
    }


def dmr_steady_state_detail():
    """Isolated steady-state per-frame cost on frame-locked voice."""
    import jax.numpy as jnp
    from dmr_synth import data_frame, group_lc, voice_frame  # tests/
    from digiham_jax.protocols.dmr.components import DATA_TYPE_VOICE_LC
    from digiham_jax.protocols.dmr.phases import SyncPhase
    from digiham_jax.runtime.tracked_bank import DmrAdapter

    lc = group_lc(2300042, 2623317)
    payload = np.tile([1, 3, 0, 2], 27)
    frames = []
    for s in range(60):
        if s < 4:
            frames.append(data_frame(s % 2, DATA_TYPE_VOICE_LC, lc))
        else:
            frames.append(voice_frame(s % 2, payload, sync=True))
    stream = np.concatenate(frames).astype(np.uint8)

    hunt = SyncPhase()
    off = 0
    nxt = None
    while nxt is None:
        nxt, c = hunt.process(stream[off:], None)
        off += c
    FS = 144
    n = (len(stream) - off) // FS
    aligned = np.tile(stream[off:off + n * FS].reshape(n, FS), (20, 1))
    n = aligned.shape[0]

    ad = DmrAdapter()
    host = ad.decode_fields(aligned, jnp)
    rows = [ad.field_row(host, r) for r in range(n)]
    t0 = time.perf_counter()
    for r in range(n):
        ad.field_row(host, r)
    dt_fr = (time.perf_counter() - t0) / n
    tr = ad.make_tracker(ad.make_meta(), 3, nxt)
    t0 = time.perf_counter()
    for f in rows:
        tr.process_fields(f)
    dt_pf = (time.perf_counter() - t0) / n
    per_frame_us = (dt_fr + dt_pf) * 1e6
    fps = 48000 / (FS * 10)
    return {
        "metric": "dmr_host_tracking_steady_state",
        "field_row_us_per_frame": round(dt_fr * 1e6, 2),
        "process_fields_us_per_frame": round(dt_pf * 1e6, 2),
        "total_us_per_frame": round(per_frame_us, 2),
        "realtime_channels_per_core": round(1e6 / (per_frame_us * fps)),
        "frames_measured": n,
    }


def bank_scaling(channels_list=(64, 256, 1024)):
    """Host control-plane scaling: does per-channel cost stay flat as the
    bank grows? (VERDICT r3 item 4.) Drives TrackedChannelBank through
    the symbol-domain entry (push_dibits — no device DSP in the timing),
    identical frame-locked DMR voice on every channel, and reports the
    per-channel-frame host cost at each bank size. A flat curve means
    the host loop is O(channels) with no superlinear term."""
    import jax.numpy as jnp  # noqa: F401 — bank import needs jax ready
    from dmr_synth import voice_frame  # tests/
    from digiham_jax.pipeline import DmrPipeline
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank

    payload = np.tile([1, 3, 0, 2], 27)
    frames = np.concatenate(
        [voice_frame(s % 2, payload, sync=True) for s in range(40)])
    rows = []
    for C in channels_list:
        bank = TrackedChannelBank(
            DmrPipeline(channels=C, sps=10, n_centuries=2),
            on_output=lambda c, d: None)
        stream = np.tile(frames, (C, 1))
        chunk = 400
        # warm: first frames compile the field-decode jits + lock trackers
        bank.push_dibits(stream[:, :chunk * 4])
        t0 = time.perf_counter()
        n_sym = 0
        for lo in range(chunk * 4, stream.shape[1] - chunk, chunk):
            bank.push_dibits(stream[:, lo:lo + chunk])
            n_sym += chunk
        dt = time.perf_counter() - t0
        frames_done = C * (n_sym // 144)
        us_pcf = dt / frames_done * 1e6
        fps = 48000 / (144 * 10)
        rows.append({
            "metric": "dmr_host_bank_scaling",
            "channels": C,
            "us_per_channel_frame": round(us_pcf, 2),
            "realtime_channels_per_core": round(1e6 / (us_pcf * fps)),
        })
    return rows


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(dmr_steady_state_detail()), flush=True)
    for row in bank_scaling():
        print(json.dumps(row), flush=True)
    for name, stream, rate in _streams():
        print(json.dumps(bench_bank(name, stream, rate)), flush=True)


if __name__ == "__main__":
    main()
