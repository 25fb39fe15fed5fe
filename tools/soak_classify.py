"""Machine-classify accelerator soak misses against the knife-edge classes.

The GPU demod kernel's summation order differs from the XLA reduce
order, which can flip knife-edge slicer decisions and flat-variance-valley
timing ties vs the envelope path (docs/ARCHITECTURE.md precision
envelope). Rather than attribute a soak miss to those classes by
narrative, this module does it by machine: it re-demodulates the divergent channel's exact sample
stream through an INSTRUMENTED f32 host oracle (reference-faithful,
dsp/demod.py) and checks whether the miss's symbol window actually
contains a knife-edge condition:

- ``slicer-boundary``: some symbol's mid-third average sits within
  SLICER_TOL of an AGC slicer threshold (center/umid/lmid), relative to
  the AGC span — an f32-reassociation-sized nudge flips the dibit.
- ``flat-valley-tie``: a century boundary feeding the window has a
  timing-variance valley whose two smallest entries are within
  VALLEY_TOL relative — the argmin (first-min-wins) is order-sensitive.
- ``timing-settle``: the miss is in the first frames before the first
  accepted timing update — the documented acquisition loss.

Anything else returns ``UNCLASSIFIED`` — a real bug, not noise.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from digiham_jax.dsp.demod import FskDemodNp, GfskDemodNp  # noqa: E402

# Tolerances sized to the documented hardware flip rates: f32 sum-order
# perturbations are O(1e-6) relative, so a decision within 1e-3 of its
# threshold is "knife-edge" with huge margin while a genuinely wrong
# symbol (whole-level error ~ 0.25 of span) never qualifies.
SLICER_TOL = 1e-3  # fraction of the AGC span (vmax - vmin)
VALLEY_TOL = 1e-3  # relative flatness of the variance valley


class _InstrumentedGfsk(GfskDemodNp):
    def __init__(self, sps: int):
        # f32 mirrors the device kernel's precision class
        super().__init__(sps, precision="f32")
        self.margins = []    # per symbol: distance to nearest threshold
        self.centuries = []  # (symbol_index, valley_flatness, offset)

    def _slice(self, average, vmin, vmax, center):
        span = max(float(vmax) - float(vmin), 1e-30)
        umid = (vmax - center) * np.float32(0.625) + center
        lmid = (vmin - center) * np.float32(0.625) + center
        m = min(abs(float(average) - float(t))
                for t in (center, umid, lmid))
        self.margins.append(m / span)
        return super()._slice(average, vmin, vmax, center)

    def _on_century(self, var, vmin_pos, applied_offset):
        v = np.sort(np.asarray(var, np.float64))
        flat = float((v[1] - v[0]) / max(v[0], 1e-30))
        self.centuries.append((len(self.margins), flat,
                               int(applied_offset)))


class _InstrumentedFsk(FskDemodNp):
    def __init__(self, sps: int, invert: bool = False):
        super().__init__(sps, invert=invert, precision="f32")
        self.margins = []
        self.centuries = []

    def _slice(self, average, vmin, vmax, center):
        span = max(float(vmax) - float(vmin), 1e-30)
        self.margins.append(abs(float(average) - float(center)) / span)
        return super()._slice(average, vmin, vmax, center)

    _on_century = _InstrumentedGfsk._on_century


def oracle_trace(samples: np.ndarray, sps: int = 10, mode: str = "gfsk",
                 invert: bool = False):
    """Demodulate the full stream through the instrumented oracle.

    Returns (dibits, margins, centuries) — the oracle's symbol stream
    (bit-exact vs the device's XLA path; hardware differs only at
    reassociation flips), per-symbol threshold margins, and the century
    decision log [(symbol_index, valley_flatness, applied_offset)].
    """
    d = (_InstrumentedGfsk(sps) if mode == "gfsk"
         else _InstrumentedFsk(sps, invert=invert))
    dibits = d.process(np.asarray(samples, np.float32))
    return dibits, d.margins, d.centuries


def _verdict(margins, centuries, sym_lo, sym_hi):
    """Knife-edge verdict for the symbol span [sym_lo, sym_hi)."""
    window = margins[sym_lo:sym_hi]
    min_margin = min(window) if window else float("inf")
    # timing decided at century boundaries feeding the window: include
    # the boundary just before sym_lo (its slew shifts these symbols)
    feeding = [flat for (at, flat, _off) in centuries
               if sym_lo - 100 <= at <= sym_hi]
    min_flat = min(feeding) if feeding else float("inf")
    first_update = centuries[0][0] if centuries else 0
    if min_margin < SLICER_TOL:
        verdict = "slicer-boundary"
    elif min_flat < VALLEY_TOL:
        verdict = "flat-valley-tie"
    elif sym_lo <= first_update:
        verdict = "timing-settle"
    else:
        verdict = "UNCLASSIFIED"
    return {"verdict": verdict,
            "min_slicer_margin": round(min_margin, 8),
            "min_valley_flatness": (round(min_flat, 8)
                                    if feeding else None),
            "symbols": [sym_lo, sym_hi]}


def classify_window(samples: np.ndarray, sym_lo: int, sym_hi: int,
                    sps: int = 10, mode: str = "gfsk",
                    invert: bool = False) -> dict:
    """Classify a divergence whose symbols span [sym_lo, sym_hi).

    samples: the channel's FULL filtered sample stream (the exact floats
    the device demodulated — regenerate with the soak's per-(block,
    channel) seeds). Returns a dict with ``verdict`` plus the evidence
    (minimum slicer margin in the window, flattest feeding valley).
    """
    _dib, margins, centuries = oracle_trace(samples, sps, mode, invert)
    return _verdict(margins, centuries, sym_lo, sym_hi)


def classify_root(device_dibits: np.ndarray, oracle_dibits: np.ndarray,
                  margins, centuries, sym_lo: int, sym_hi: int) -> dict | None:
    """Root-cause a cascade miss at [sym_lo, sym_hi): a knife-edge TIMING
    flip upstream (a tied variance valley resolving differently under
    hardware reassociation) slews the device's sampling phase, so
    symbols diverge for a transient with healthy oracle margins until
    the tracker re-converges — the miss's own window then classifies
    UNCLASSIFIED even though the cause is the documented envelope.

    The rigorous check uses the device's RECORDED dibit stream: find the
    contiguous divergence EPISODE (vs the oracle, gaps < one century)
    containing the frame's divergent symbols, and classify the episode's
    FIRST symbol — the trajectories are bit-identical before it, so
    that is the root decision. (Isolated upstream flips outside the
    episode are NOT blamed: slicer decisions don't feed back into the
    AGC/timing state, so they cannot cascade.) Returns the root verdict
    dict (with ``root_symbol``), or None if the streams agree
    everywhere before ``sym_hi`` — i.e. no device-side root exists.
    """
    n = min(len(device_dibits), len(oracle_dibits), sym_hi)
    diff = np.nonzero(np.asarray(device_dibits[:n], np.uint8)
                      != np.asarray(oracle_dibits[:n], np.uint8))[0]
    if len(diff) == 0:
        return None
    # episode = maximal run of diffs ending at the last diff before
    # sym_hi with inter-diff gaps < 100 symbols (one timing century)
    root = int(diff[-1])
    for d in diff[::-1][1:]:
        if root - int(d) >= 100:
            break
        root = int(d)
    out = _verdict(margins, centuries, root, root + 1)
    out["root_symbol"] = root
    return out


def noise_errors(oracle_dibits: np.ndarray, tx_dibits: np.ndarray,
                 sym_lo: int, sym_hi: int) -> int:
    """Count oracle-vs-TX symbol errors in [sym_lo, sym_hi): the host
    oracle ITSELF misdecodes the noisy stream — a channel-noise error,
    reproducible bit-for-bit on every backend (the compiled reference
    fed the same audio fails the same frame). Checked FIRST: such a
    miss is not an implementation or hardware divergence at all.
    (Observed: at soak noise sigma=60 a symbol's mid-third average lands
    on the wrong side of a slicer threshold a few times per ~10^7
    symbols — the device agreed with the oracle exactly, and the margin
    was healthy, so both knife-edge and cascade checks said
    UNCLASSIFIED until this class existed.)"""
    o = np.asarray(oracle_dibits[sym_lo:sym_hi], np.uint8)
    t = np.asarray(tx_dibits[sym_lo:sym_hi], np.uint8)
    n = min(len(o), len(t))
    return int(np.count_nonzero(o[:n] != t[:n]))


def rrc_np(x: np.ndarray, design) -> np.ndarray:
    """Device-free replica of the pipeline's streaming RRC on one
    channel (zero initial history, the bank's init state): y[t] =
    sum_j taps[j] * x_full[t + j]. The knife-edge tolerances are ~1e-3
    of span, far above np-vs-XLA f32 differences."""
    taps = np.asarray(design.scaled_taps, np.float64)
    xf = np.concatenate([np.zeros(len(taps) - 1), np.asarray(x, np.float64)])
    return np.convolve(xf, taps[::-1], mode="valid").astype(np.float32)


def diff_frames(emitted: bytes, want: bytes, expect: int) -> dict:
    """Align a channel's emitted payload stream against ``expect``
    repetitions of ``want``: returns corrupted chunk indexes and the
    shortfall (frames never emitted)."""
    n = len(want)
    chunks = [emitted[i:i + n] for i in range(0, len(emitted), n)]
    corrupted = [k for k, c in enumerate(chunks) if c != want]
    return {"corrupted": corrupted,
            "shortfall": max(0, expect - len(chunks)),
            "emitted": len(chunks)}
