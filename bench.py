"""Headline benchmark: raw-IQ DMR decode throughput on one GPU.

Measures the fused device pipeline (FM quadrature discriminator -> RRC
FIR -> 4FSK demod -> dense sync correlation -> batched per-frame FEC
decode) over a 256-channel bank (BASELINE.json configs[4]) and reports
Msamples/s of raw IQ consumed — the BASELINE.json metric.

Method, in one process: compile and warm up the step, then time
``BENCH_STEPS`` steps, each ended with ``block_until_ready``, and report
the median. Inputs are random IQ made on the device once; every step
starts from the same state, so steps are independent and equal in work.

Baseline: the reference is a real-time single-channel CPU pipeline at
48 kS/s per channel (BASELINE.md). ``vs_baseline`` is the number of
reference real-time channels one GPU sustains: value_msps / 0.048.

Needs a GPU: without one it prints an error line and exits 2. Prints ONE
JSON line.
"""
import json
import os
import statistics
import subprocess
import sys
import time


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return r.stdout.strip() or f"unavailable (rc {r.returncode})"


def summarize(step_seconds, channels: int, samples_per_step: int,
              frame_windows_per_step: int) -> dict:
    """Throughput fields from per-step wall times (seconds)."""
    dt = statistics.median(step_seconds)
    msps = channels * samples_per_step / dt / 1e6
    return {
        "value": msps,
        "vs_baseline": msps / 0.048,
        "per_step_seconds": dt,
        "step_seconds_min": min(step_seconds),
        "step_seconds_max": max(step_seconds),
        # every 144-dibit window of the block is field-decoded on the
        # device, locked or not: windows, not decoded frames
        "frame_windows_decoded_per_s": frame_windows_per_step / dt,
    }


def main() -> int:
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    result = {"metric": "dmr_iq_pipeline_throughput",
              "unit": "Msamples/s", "device": device}
    if dev.platform != "gpu":
        result.update(value=None, error=f"no GPU: jax found {device}")
        print(json.dumps(result))
        return 2

    from digiham_jax.utils import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp

    from digiham_jax.pipeline import DmrPipeline

    channels = int(os.environ.get("BENCH_CHANNELS", "256"))
    n_cent = int(os.environ.get("BENCH_CENTURIES", "16"))
    n_steps = int(os.environ.get("BENCH_STEPS", "50"))
    sps = 10
    pipe = DmrPipeline(channels=channels, sps=sps, n_centuries=n_cent)
    L = n_cent * (100 * sps + 1) + 2 * sps
    samples_per_step = n_cent * 100 * sps  # per channel, consumed

    keys = jax.random.split(jax.random.key(0), 4)
    iqs = [jax.lax.complex(jax.random.normal(keys[i], (channels, L)),
                           jax.random.normal(keys[i + 2], (channels, L)))
           for i in range(2)]
    last = jnp.ones((channels,), jnp.complex64)
    state0 = pipe.init_state()
    step = jax.jit(lambda iq, last, st: pipe.step_iq(iq, last, st))

    t0 = time.perf_counter()
    jax.block_until_ready(step(iqs[0], last, state0))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(step(iqs[1], last, state0))

    times = []
    for k in range(n_steps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(iqs[k % 2], last, state0))
        times.append(time.perf_counter() - t0)

    result.update(summarize(times, channels, samples_per_step,
                            channels * (n_cent * 100 // 144)))
    result.update(
        channels=channels, centuries=n_cent, steps=n_steps,
        samples_per_step=samples_per_step, compile_seconds=compile_s,
        card=card_line(),
        peak_bytes_in_use=dev.memory_stats().get("peak_bytes_in_use"))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
