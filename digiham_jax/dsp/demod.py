"""2FSK / 4FSK (C4FM) symbol demodulators, batched over channels.

Reference behavior (src/fsk_demodulator/fsk_demodulator.cpp:25-111,
src/gfsk_demodulator/gfsk_demodulator.cpp:24-122): a per-symbol loop that
(1) integrates the middle third of each symbol window, (2) tracks signal
level min/max over a 100-symbol volume ring to derive the slicer thresholds
(AGC), and (3) every 100 symbols computes the per-offset variance over a
100-symbol sample ring and slews the read pointer by ±1 sample (symbol
timing recovery).

Block re-design: the timing loop only updates once per 100 symbols, so
the natural unit of work is a **century** (100 symbols). The plain block
program is a ``lax.scan`` over centuries; *within* a century every
per-symbol quantity vectorizes:

- symbol windows: one gather -> ``[100, sps]`` matrix,
- mid-third integration / volume average: axis reductions,
- the sliding 100-entry AGC window: a ``[100, 100]`` windowed gather over
  the concatenation of the previous century's volumes and this century's,
- the timing variance: column-wise variance of the same ``[100, sps]``
  matrix (the reference's variance ring refills exactly once per century,
  so it needs no carry at all).

The carry is tiny: read position, pending ±1 slew, and the 100-entry volume
ring. Channels batch with ``vmap``/``shard_map``; a [C]-channel block is
pure vector work of width C. On a GPU the serial part — the timing
recursion alone — runs as one Triton kernel (ops/demod_triton.py) and the
AGC + slicer run afterwards for the whole block (``_agc_slice_block``).

Sample-position semantics match the reference exactly: the slew decided at
the end of century ``c`` is applied in the *advance* of the first symbol of
century ``c+1``, i.e. it shifts the windows of symbols 1..99 of century
``c+1`` and every century thereafter (fsk_demodulator.cpp:37-39: advance
happens before the variance evaluation, and the offset resets after use).

Documented divergences (decision-invariant in practice):
- The reference accumulates the timing variance in ``double``; we use
  float32 on device (the accept window is 0 < vmin <= 5e6 — a 7-decade
  band) — the host oracle can run either precision.
- The reference's volume ring starts as uninitialized-but-practically-zero
  memory; we define it as zeros.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

VARIANCE_SYMBOLS = 100  # fsk_demodulator.hpp:5
VOLUME_RB_SIZE = 100    # fsk_demodulator.hpp:6
CENTURY = 100
FLT_MIN = np.float32(1.17549435e-38)  # max starts at FLT_MIN (cpp:104)
VMIN_GUARD = 5000000.0  # fsk_demodulator.cpp:70


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DemodState:
    """Per-channel streaming carry."""

    pos: jnp.ndarray          # [C] int32: read position of next symbol
    offset: jnp.ndarray       # [C] int32: pending ±1 slew for next century
    volume_ring: jnp.ndarray  # [C, 100] float32: last century's volumes

    def tree_flatten(self):
        return (self.pos, self.offset, self.volume_ring), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def demod_init(channels: int) -> DemodState:
    return DemodState(
        pos=jnp.zeros((channels,), jnp.int32),
        offset=jnp.zeros((channels,), jnp.int32),
        volume_ring=jnp.zeros((channels, VOLUME_RB_SIZE), jnp.float32),
    )


def _eval_bounds(sps: int) -> tuple[int, int]:
    """lowestEval/highestEval = round(sps/3), round(2*sps/3) (cpp:8-10)."""
    lo = int(np.round(sps / 3))
    hi = int(np.round(sps * 2 / 3))
    return lo, hi


def _sliding_minmax_100(concat: jnp.ndarray):
    """Sliding min/max over all 100 length-100 windows along the last axis
    of a [..., 200] array, gather-free: the two-block prefix/suffix
    cumulative trick. Window i spans concat[..., i+1 : i+101]."""
    blk0, blk1 = concat[..., :100], concat[..., 100:]
    # suffix extrema of block 0 (suf[i] = extremum of blk0[i:])
    suf_max = jax.lax.cummax(blk0, axis=blk0.ndim - 1, reverse=True)
    suf_min = jax.lax.cummin(blk0, axis=blk0.ndim - 1, reverse=True)
    pre_max = jax.lax.cummax(blk1, axis=blk1.ndim - 1)
    pre_min = jax.lax.cummin(blk1, axis=blk1.ndim - 1)
    # window i = blk0[i+1:] + blk1[:i+1]; for i=99 only blk1
    left_max = jnp.concatenate([suf_max[..., 1:], suf_max[..., -1:]], -1)
    left_min = jnp.concatenate([suf_min[..., 1:], suf_min[..., -1:]], -1)
    use_left = jnp.arange(100) < 99
    wmax = jnp.where(use_left, jnp.maximum(left_max, pre_max), pre_max)
    wmin = jnp.where(use_left, jnp.minimum(left_min, pre_min), pre_min)
    return wmin, wmax


def _slice(mid_avg, vmin_level, wmax, mode: str, invert: bool):
    """Slicer: thresholds from the AGC window's extrema (gfsk cpp:93-105,
    fsk cpp:102-111)."""
    vmax = jnp.maximum(wmax, FLT_MIN)
    center = (vmax + vmin_level) / 2
    if mode == "gfsk":
        umid = (vmax - center) * 0.625 + center
        lmid = (vmin_level - center) * 0.625 + center
        # >umid: 1, >center: 0, <lmid: 3, else: 2
        return jnp.where(
            mid_avg > center,
            jnp.where(mid_avg > umid, 1, 0),
            jnp.where(mid_avg < lmid, 3, 2),
        ).astype(jnp.uint8)
    one = 0 if invert else 1
    return jnp.where(mid_avg > center, one, 1 - one).astype(jnp.uint8)


def _century(samples, pos, offset, volume_ring, sps: int, mode: str,
             invert: bool):
    """Demodulate one century for one channel.

    samples: [L] float32 (whole block; we slice dynamically).
    Returns (symbols [100] uint8, new_pos, new_offset, new_volume_ring).

    Gather-free inner loop: the +-1 timing shift selects between three
    statically-sliced views, and the AGC sliding window uses cumulative
    extrema.
    """
    lo, hi = _eval_bounds(sps)
    span = CENTURY * sps + 1
    window = jax.lax.dynamic_slice(samples, (pos,), (span,))

    # Symbol sample matrix [100, sps]: symbol i>=1 shifted by the pending
    # slew (consumed by the first advance of this century).
    wp = jnp.concatenate([jnp.zeros((1,), window.dtype), window])  # pad
    view = {
        s: jax.lax.slice(wp, (1 + s,), (1 + s + CENTURY * sps,))
             .reshape(CENTURY, sps)
        for s in (-1, 0, 1)
    }
    shifted = jnp.where(offset == 1, view[1],
                        jnp.where(offset == -1, view[-1], view[0]))
    row0 = jnp.arange(CENTURY)[:, None] == 0
    sym = jnp.where(row0, view[0], shifted)  # [100, sps]

    volume_avg = jnp.mean(sym, axis=1)                      # [100]
    mid_avg = jnp.sum(sym[:, lo:hi], axis=1) / (hi - lo)    # [100]

    # AGC: after writing symbol i's volume, the ring holds volumes
    # i-99 .. i; min/max over it defines the slicer thresholds (cpp:102-111).
    concat = jnp.concatenate([volume_ring, volume_avg])     # [200]
    vmin_level, wmax = _sliding_minmax_100(concat)
    symbols = _slice(mid_avg, vmin_level, wmax, mode, invert)

    # Timing: column-wise variance of the century's sample matrix
    # (fsk cpp:41-79). First minimum wins (strict <).
    col_mean = jnp.sum(sym, axis=0) / VARIANCE_SYMBOLS
    variance = jnp.sum((col_mean[None, :] - sym) ** 2, axis=0) / VARIANCE_SYMBOLS
    vmin = jnp.min(variance)
    vmin_pos = jnp.argmin(variance)
    guard_ok = (vmin > 0) & (vmin <= VMIN_GUARD)
    step_left = (vmin_pos > 0) & (vmin_pos < sps // 2)
    step_right = (vmin_pos >= sps // 2) & (vmin_pos < sps - 1)
    new_offset = jnp.where(
        guard_ok,
        jnp.where(step_left, 1, jnp.where(step_right, -1, 0)),
        0,
    ).astype(jnp.int32)

    new_pos = pos + CENTURY * sps + offset
    return symbols, new_pos, new_offset, volume_avg


def _demod_block_single(samples, pos, offset, volume_ring,
                        n_centuries: int, sps: int, mode: str, invert: bool):
    """[L] samples, scalar state -> ([n_centuries*100] symbols, state)."""

    def step(carry, _):
        pos, offset, ring = carry
        symbols, pos, offset, ring = _century(
            samples, pos, offset, ring, sps, mode, invert
        )
        return (pos, offset, ring), symbols

    (pos, offset, ring), symbols = jax.lax.scan(
        step, (pos, offset, volume_ring), None, length=n_centuries
    )
    return symbols.reshape(-1), pos, offset, ring


def _demod_block_xla(samples, state, n_centuries, sps, mode, invert):
    f = functools.partial(_demod_block_single, n_centuries=n_centuries,
                          sps=sps, mode=mode, invert=invert)
    symbols, pos, offset, ring = jax.vmap(f)(
        samples, state.pos, state.offset, state.volume_ring
    )
    return symbols, DemodState(pos, offset, ring)


def _agc_slice_block(ring, vols, mids, mode: str, invert: bool):
    """AGC + slicer for every century of a block at once.

    ring: [C, 100] volumes of the century before the block; vols/mids:
    [C, nc, 100] per-symbol volume and mid-third averages. Symbol i of
    century c sees the 100-volume window ending at itself, drawn from
    [previous century | this century] — none of it feeds the timing
    recursion, so it needs no loop. Returns (symbols [C, nc*100] uint8,
    new ring [C, 100])."""
    prev = jnp.concatenate([ring[:, None], vols[:, :-1]], axis=1)
    wmin, wmax = _sliding_minmax_100(jnp.concatenate([prev, vols], axis=-1))
    symbols = _slice(mids, wmin, wmax, mode, invert)
    return symbols.reshape(symbols.shape[0], -1), vols[:, -1]


def _demod_block_gpu(samples, state, n_centuries, sps, mode, invert,
                     interpret=False):
    """The timing recursion in one Pallas-on-Triton kernel
    (ops/demod_triton.py), then AGC and slicer as batched XLA."""
    from ..ops.demod_triton import century_stats

    vols, mids, pos, offset = century_stats(
        samples, state.pos, state.offset, n_centuries, sps,
        interpret=interpret)
    symbols, ring = _agc_slice_block(state.volume_ring, vols, mids, mode,
                                     invert)
    return symbols, DemodState(pos, offset, ring)


def use_gpu_kernel(impl: str) -> bool:
    """Kernel choice: impl="auto" on a GPU takes the Triton kernel;
    anything else (impl="xla", or any other backend) takes the plain
    ``lax.scan``. A kernel that fails on the GPU fails loudly."""
    if impl not in ("auto", "xla"):
        raise ValueError(f"impl must be 'auto' or 'xla', got {impl!r}")
    return impl == "auto" and jax.default_backend() == "gpu"


def _demod_block(samples, state, n_centuries, sps, mode, invert, impl):
    if use_gpu_kernel(impl):
        return _demod_block_gpu(samples, state, n_centuries, sps, mode,
                                invert)
    return _demod_block_xla(samples, state, n_centuries, sps, mode, invert)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def gfsk_demod_block(samples: jnp.ndarray, state: DemodState,
                     n_centuries: int, sps: int = 10,
                     _unused: bool = False, impl: str = "auto"):
    """4FSK demodulate a block.

    samples: [C, L] float32 with L >= max(state.pos) + n_centuries*(100*sps
    + 1) + 1 slack per century of potential slew.
    impl: "auto" (the Triton kernel on a GPU, the XLA scan elsewhere) or
    "xla" (the scan everywhere — required under GSPMD auto-partitioning,
    which cannot split a Triton custom call; shard_map paths keep "auto").
    Returns (dibits [C, n_centuries*100] uint8, new DemodState). The new
    state's ``pos`` stays relative to this block's origin; the stream driver
    rebases it when it discards consumed samples.
    """
    return _demod_block(samples, state, n_centuries, sps, "gfsk", False,
                        impl)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def fsk_demod_block(samples: jnp.ndarray, state: DemodState,
                    n_centuries: int, sps: int = 40, invert: bool = False,
                    impl: str = "auto"):
    """2FSK demodulate a block: bits 0/1 per symbol. See gfsk_demod_block."""
    return _demod_block(samples, state, n_centuries, sps, "fsk", invert,
                        impl)


def rrc_demod_block(samples, rrc_state, demod_state, n_centuries: int,
                    sps: int, design=None, mode: str = "gfsk",
                    invert: bool = False, impl: str = "auto"):
    """The RRC -> demod segment every protocol pipeline shares.

    design=None skips the filter (pre-filtered input).
    Returns (symbols, new_rrc_state, new_demod_state)."""
    from .rrc import rrc_filter_block

    if design is not None:
        filtered, rrc_state = rrc_filter_block(samples, rrc_state, design)
    else:
        filtered = samples
    if mode == "gfsk":
        sym, demod_state = gfsk_demod_block(filtered, demod_state,
                                            n_centuries, sps, impl=impl)
    else:
        sym, demod_state = fsk_demod_block(filtered, demod_state,
                                           n_centuries, sps, invert,
                                           impl=impl)
    return sym, rrc_state, demod_state


class _DemodNp:
    """Host oracle: symbol-at-a-time loop faithful to the reference
    (fsk_demodulator.cpp:25-111), for tests and the control plane.

    precision='f64' mirrors the C double math in the variance loop;
    'f32' mirrors the device kernel.
    """

    def __init__(self, sps: int, invert: bool = False, precision: str = "f64"):
        self.sps = sps
        self.invert = invert
        self.lo, self.hi = _eval_bounds(sps)
        self.var_dtype = np.float64 if precision == "f64" else np.float32
        self.variance_rb = np.zeros(VARIANCE_SYMBOLS * sps, np.float32)
        self.variance_rb_pos = 0
        self.variance_offset = 0
        self.volume_rb = np.zeros(VOLUME_RB_SIZE, np.float32)
        self.volume_rb_pos = 0
        self.pos = 0  # absolute read index into the caller's stream

    def _calibrate(self):
        vmin = np.float32(self.volume_rb.min())
        vmax = np.float32(max(self.volume_rb.max(), FLT_MIN))
        center = (vmax + vmin) / 2
        return vmin, vmax, center

    def _slice(self, average, vmin, vmax, center):
        raise NotImplementedError

    def _on_century(self, var, vmin_pos, applied_offset):
        """Instrumentation hook: called at each century boundary with the
        per-offset timing variance vector and the decision. No-op here;
        tools/soak_classify.py subclasses it to machine-check hardware
        soak misses against the knife-edge classes (flat variance-valley
        ties, slicer-boundary flips)."""

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Consume as many symbols as available; returns symbol array."""
        samples = np.asarray(samples, dtype=np.float32)
        out = []
        while self.pos + self.sps + 1 < len(samples):
            window = samples[self.pos:self.pos + self.sps]
            self.variance_rb[
                self.variance_rb_pos:self.variance_rb_pos + self.sps
            ] = window
            self.pos += self.sps + self.variance_offset
            self.variance_offset = 0

            self.variance_rb_pos += self.sps
            if self.variance_rb_pos >= len(self.variance_rb):
                rb = self.variance_rb.reshape(VARIANCE_SYMBOLS, self.sps)
                totals = rb.sum(axis=0, dtype=np.float32)
                means = totals.astype(self.var_dtype) / VARIANCE_SYMBOLS
                var = (
                    ((means[None, :] - rb.astype(self.var_dtype)) ** 2).sum(0)
                    / VARIANCE_SYMBOLS
                )
                vmin_pos = int(np.argmin(var))  # first min wins
                vmin = var[vmin_pos]
                if vmin <= 0 or vmin > VMIN_GUARD:
                    pass
                elif 0 < vmin_pos < self.sps // 2:
                    self.variance_offset = +1
                elif self.sps // 2 <= vmin_pos < self.sps - 1:
                    self.variance_offset = -1
                self.variance_rb_pos = 0
                self._on_century(var, vmin_pos, self.variance_offset)

            self.volume_rb[self.volume_rb_pos] = window.mean(dtype=np.float32)
            self.volume_rb_pos = (self.volume_rb_pos + 1) % VOLUME_RB_SIZE

            vmin, vmax, center = self._calibrate()
            average = np.float32(
                window[self.lo:self.hi].sum(dtype=np.float32)
                / (self.hi - self.lo)
            )
            out.append(self._slice(average, vmin, vmax, center))
        return np.asarray(out, dtype=np.uint8)


class FskDemodNp(_DemodNp):
    def _slice(self, average, vmin, vmax, center):
        if average > center:
            return 0 if self.invert else 1
        return 1 if self.invert else 0


class GfskDemodNp(_DemodNp):
    def _slice(self, average, vmin, vmax, center):
        umid = (vmax - center) * np.float32(0.625) + center
        lmid = (vmin - center) * np.float32(0.625) + center
        if average > center:
            return 1 if average > umid else 0
        return 3 if average < lmid else 2
