"""Soak-miss machine classification (tools/soak_classify.py): knife-edge
windows are recognized, healthy windows are NOT explained away."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from soak_classify import (classify_window, diff_frames, rrc_np,  # noqa: E402
                           SLICER_TOL)

LEVELS = np.array([1.0, 3.0, -1.0, -3.0], np.float32) / 3.0
SPS = 10


def _stream(n_sym=1200, seed=3, noise=25.0, amp=1000.0):
    rng = np.random.default_rng(seed)
    dib = rng.integers(0, 4, n_sym).astype(np.uint8)
    x = np.repeat(LEVELS[dib], SPS) * amp
    return (x + rng.normal(0, noise, x.shape)).astype(np.float32), dib


def test_healthy_window_is_unclassified():
    """An RRC-shaped noisy-but-comfortable stream has a distinct timing
    valley and wide slicer margins: a divergence there must surface as
    UNCLASSIFIED (a real bug), not be explained away as knife-edge."""
    from digiham_jax.dsp.rrc import WIDE_RRC
    raw, _ = _stream()
    filt = rrc_np(raw, WIDE_RRC)
    r = classify_window(filt, 400, 544, sps=SPS)
    assert r["verdict"] == "UNCLASSIFIED", r
    assert r["min_slicer_margin"] > SLICER_TOL


def test_slicer_boundary_detected():
    """Pin one symbol's samples exactly onto the upper slicer threshold.

    Clean rectangular 4FSK at amp=1000 makes the AGC analytic once the
    volume ring holds both extremes: vmax=1000, vmin=-1000, center=0,
    umid = (vmax-center)*0.625f32 + center = 625 exactly, and the
    timing argmin is offset 0 (flat columns) so symbol i occupies
    samples [i*sps, (i+1)*sps) throughout."""
    raw, _ = _stream(seed=5, noise=0.0)
    s = 450
    raw = raw.copy()
    raw[s * SPS:(s + 1) * SPS] = np.float32(625.0)
    r = classify_window(raw, 440, 470, sps=SPS)
    assert r["verdict"] == "slicer-boundary", r
    assert r["min_slicer_margin"] < 1e-6


def test_flat_valley_tie_detected():
    """Unshaped rectangular pulses have an exactly flat timing-variance
    valley — the canonical order-sensitive argmin tie."""
    raw, _ = _stream(noise=0.0)
    r = classify_window(raw, 300, 444, sps=SPS)
    assert r["verdict"] == "flat-valley-tie", r


def test_timing_settle_class():
    """A divergence before the first timing update is the documented
    acquisition class (given margins/valley look healthy)."""
    from digiham_jax.dsp.rrc import WIDE_RRC
    raw, _ = _stream(seed=9)
    filt = rrc_np(raw, WIDE_RRC)
    r = classify_window(filt, 0, 80, sps=SPS)
    assert r["verdict"] in ("timing-settle", "slicer-boundary",
                            "flat-valley-tie")


def test_diff_frames():
    want = b"x" * 27
    other = b"y" * 27
    d = diff_frames(want * 3 + other + want, want, 6)
    assert d == {"corrupted": [3], "shortfall": 1, "emitted": 5}
    d = diff_frames(want * 6, want, 6)
    assert d == {"corrupted": [], "shortfall": 0, "emitted": 6}


def test_classify_root_episode_grouping():
    """A cascade miss is attributed to the FIRST symbol of the contiguous
    device-vs-oracle divergence episode containing the frame; isolated
    upstream flips (gap >= one century) are NOT blamed — slicer
    decisions don't feed back into the AGC/timing state."""
    from soak_classify import classify_root
    orc = np.zeros(10000, np.uint8)
    dev = orc.copy()
    dev[200] ^= 1                                  # isolated: not blamed
    dev[5000] ^= 1; dev[5040] ^= 1; dev[5120] ^= 1  # the episode
    margins = [1.0] * 10000
    margins[5000] = 1e-5                           # root IS knife-edge
    cents = [(100, 1.0, 0)]
    r = classify_root(dev, orc, margins, cents, 5100, 5244)
    assert r["root_symbol"] == 5000
    assert r["verdict"] == "slicer-boundary"


def test_classify_root_timing_flip():
    """Root at a tied variance valley classifies flat-valley-tie even
    when every slicer margin along the episode is healthy."""
    from soak_classify import classify_root
    orc = np.zeros(10000, np.uint8)
    dev = orc.copy()
    dev[5000:5144] ^= 1                            # slewed transient
    margins = [1.0] * 10000
    cents = [(100, 1.0, 0), (4950, 1e-5, 1)]       # tie feeds the root
    r = classify_root(dev, orc, margins, cents, 5100, 5244)
    assert r["root_symbol"] == 5000
    assert r["verdict"] == "flat-valley-tie"


def test_classify_root_no_divergence_returns_none():
    from soak_classify import classify_root
    orc = np.zeros(1000, np.uint8)
    assert classify_root(orc.copy(), orc, [1.0] * 1000,
                         [(10, 1.0, 0)], 500, 644) is None


def test_classify_root_real_bug_stays_unclassified():
    """A divergence whose episode root has healthy margins AND healthy
    feeding valleys must stay UNCLASSIFIED — a real bug."""
    from soak_classify import classify_root
    orc = np.zeros(10000, np.uint8)
    dev = orc.copy()
    dev[5050] ^= 1
    r = classify_root(dev, orc, [1.0] * 10000, [(100, 1.0, 0)],
                      5040, 5184)
    assert r["verdict"] == "UNCLASSIFIED"


def test_noise_errors_counts_oracle_vs_tx():
    """A window where the host oracle itself misdecodes (oracle != TX)
    is a channel-noise error — identical on every backend — and must be
    classified before any divergence logic runs."""
    from soak_classify import noise_errors
    tx = np.zeros(1000, np.uint8)
    orc = tx.copy()
    orc[500] = 2
    orc[510] = 1
    assert noise_errors(orc, tx, 432, 576) == 2
    assert noise_errors(orc, tx, 0, 144) == 0
