"""tools/bench_latency.py invariants (docs/LATENCY.md serving rows).

The doc's headline claim for the serving operating point — "no
algorithmic queueing: sharding channels across MultiStreamBank workers
adds zero buffering latency" — is an invariant of the design (workers
are independent TrackedChannelBanks), so it must hold exactly on CPU
with tiny shapes, not just in the hardware table. Reference bar: the
per-sample C++ pipeline composition has the same property (independent
processes per channel, examples/dmr-decoder.sh).
"""
import importlib.util
import os

import numpy as np

_BL = os.path.join(os.path.dirname(__file__), "..", "tools",
                   "bench_latency.py")


def _load():
    spec = importlib.util.spec_from_file_location("bench_latency", _BL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_multistream_latency_equals_single_bank():
    bl = _load()
    from digiham_jax.pipeline import DmrPipeline
    from digiham_jax.runtime.multistream import MultiStreamBank
    from digiham_jax.runtime.tracked_bank import TrackedChannelBank

    channels, nc, block = 2, 2, 4800
    streams = [bl.synth_stream(9100 + c, n_bursts=2) for c in range(channels)]
    n = max(len(s[0]) for s in streams)
    dots = np.tile(np.array([0, 2], np.uint8), (n + 1) // 2)
    samples = np.stack([
        bl.modulate(np.concatenate([s[0], dots[:n - len(s[0])]]))
        for s in streams])

    def run(make):
        ends = [dict(s[1]) for s in streams]
        lat, _walls, missed = bl.drive(make, samples, ends, block)
        assert missed == 0, f"{missed} synthesized frames never decoded"
        return sorted(lat)

    single = run(lambda cb: TrackedChannelBank(
        DmrPipeline(channels=channels, sps=bl.SPS, n_centuries=nc),
        on_output=cb))
    multi = run(lambda cb: MultiStreamBank(
        "dmr", channels=channels, n_procs=2, on_output=cb,
        pipeline_kwargs={"n_centuries": nc, "sps": bl.SPS}))

    # identical streams, identical pipeline config => identical per-frame
    # algorithmic latency: process sharding must add zero buffering
    assert multi == single
