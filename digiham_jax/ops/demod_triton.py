"""Pallas-on-Triton kernel: the serial timing recursion of the century
demodulator, for Hopper GPUs.

Of the demodulator's work only the symbol-timing recursion is serial:
century ``c+1``'s read position depends on the ±1 slew decided from
century ``c``'s timing variance (fsk_demodulator.cpp:37-79). Everything
else — the AGC's sliding min/max and the slicer — depends only on the
per-symbol volume and mid-third averages, so it runs afterwards as plain
batched XLA (``dsp.demod._agc_slice_block``).

The plain form (``dsp.demod._demod_block_xla``) is a ``lax.scan`` over
centuries; on a GPU every iteration relaunches its small fusions. This
kernel keeps the whole loop on the device in one launch:

- one program per channel (256 channels fill the 132 SMs about twice);
- ``lax.fori_loop`` over centuries with (pos, offset) carried as scalars;
- each century's symbol matrix is one masked gather of a power-of-two
  ``[128, next_pow2(sps)]`` block at ``pos + 100*sps`` steps — rows past
  100 symbols and columns past ``sps`` are zeroed, so padding never
  reaches a statistic;
- per-symbol volume / mid-third averages go out as ``[C, nc, 128]`` rows;
  the timing decision stays in registers.

Float summation order differs from the XLA reductions, so knife-edge
slicer decisions may flip on noisy input; decisions on clean input are
identical (tests/test_demod_triton.py, chip_smoke.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..dsp.demod import CENTURY, VMIN_GUARD, _eval_bounds

ROWS = 128  # 100 symbols padded to a power of two


def _stats_kernel(y_ref, pos_ref, off_ref, vol_ref, mid_ref, pos_out,
                  off_out, *, n_centuries: int, sps: int, length: int):
    from jax.experimental import pallas as pl

    ch = pl.program_id(0)
    cols = pl.next_power_of_2(sps)
    lo, hi = _eval_bounds(sps)
    r = jax.lax.broadcasted_iota(jnp.int32, (ROWS, cols), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (ROWS, cols), 1)
    valid = (r < CENTURY) & (j < sps)
    in_mid = valid & (j >= lo) & (j < hi)
    base = r * sps + j
    col = jax.lax.broadcasted_iota(jnp.int32, (cols,), 0)

    def century(c, carry):
        pos, offset = carry
        # symbol i >= 1 is shifted by the pending slew (consumed by the
        # first advance of the century, as in dsp.demod._century)
        idx = pos + base + jnp.where(r >= 1, offset, 0)
        w = y_ref[ch, jnp.clip(idx, 0, length - 1)]
        zero = jnp.zeros_like(w)
        w = jnp.where(valid, w, zero)
        vol_ref[ch, c, :] = jnp.sum(w, axis=1) / sps
        mid_ref[ch, c, :] = (jnp.sum(jnp.where(in_mid, w, zero), axis=1)
                             / (hi - lo))
        col_mean = jnp.sum(w, axis=0) / CENTURY
        d = jnp.where(valid, col_mean[None, :] - w, zero)
        var = jnp.sum(d * d, axis=0) / CENTURY
        var = jnp.where(col < sps, var, jnp.full_like(var, jnp.inf))
        vmin = jnp.min(var)
        vmin_pos = jnp.argmin(var).astype(jnp.int32)  # first minimum wins
        guard_ok = (vmin > 0) & (vmin <= VMIN_GUARD)
        step_left = guard_ok & (vmin_pos > 0) & (vmin_pos < sps // 2)
        step_right = (guard_ok & (vmin_pos >= sps // 2)
                      & (vmin_pos < sps - 1))
        # +1 / -1 / 0 as arithmetic: the Triton lowering types a weak
        # scalar in a select like the predicate (i1)
        new_offset = (step_left.astype(jnp.int32)
                      - step_right.astype(jnp.int32))
        return pos + CENTURY * sps + offset, new_offset

    pos, offset = jax.lax.fori_loop(0, n_centuries, century,
                                    (pos_ref[ch], off_ref[ch]))
    pos_out[ch] = pos
    off_out[ch] = offset


@functools.partial(jax.jit,
                   static_argnames=("n_centuries", "sps", "interpret"))
def century_stats(samples: jnp.ndarray, pos: jnp.ndarray,
                  offset: jnp.ndarray, n_centuries: int, sps: int,
                  interpret: bool = False):
    """Run the timing recursion for every channel.

    samples: [C, L] float32; pos/offset: [C] int32 (the DemodState carry).
    Reads past the block end are clamped to its last sample (the XLA
    path's dynamic_slice clamps too; stream drivers size L so neither
    happens). Returns (volume averages [C, nc, 100], mid-third averages
    [C, nc, 100], new pos [C], new offset [C]).
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    C, L = samples.shape
    kernel = functools.partial(_stats_kernel, n_centuries=n_centuries,
                               sps=sps, length=L)
    rows = jax.ShapeDtypeStruct((C, n_centuries, ROWS), jnp.float32)
    carry = jax.ShapeDtypeStruct((C,), jnp.int32)
    vol, mid, pos, offset = pl.pallas_call(
        kernel,
        grid=(C,),
        out_shape=(rows, rows, carry, carry),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="century_demod",
    )(samples.astype(jnp.float32), pos.astype(jnp.int32),
      offset.astype(jnp.int32))
    return vol[..., :CENTURY], mid[..., :CENTURY], pos, offset
