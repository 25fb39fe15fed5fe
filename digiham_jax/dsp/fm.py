"""IQ ingest front end: FM quadrature discriminator and DC blocker.

The reference pipelines receive FM-demodulated audio from external tools
(``rtl_fm``/``csdr`` — examples/dmr-decoder.sh:13-16); those stages are not
part of digiham itself. This module provides batched device equivalents so a
digiham_jax pipeline can ingest raw IQ directly on device and report the
headline IQ-Msamples/s metric end to end.

Both are stateless-per-block with a one-sample carry, fully batched over
channels.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.jit
def fm_discriminator(iq: jnp.ndarray, last: jnp.ndarray):
    """Quadrature FM discriminator.

    iq: [C, T] complex64; last: [C] complex64 carry (last sample of the
    previous block, init 1+0j).
    Returns (audio [C, T] float32 in [-1, 1] scaled by 1/pi, new carry).
    """
    prev = jnp.concatenate([last[:, None], iq[:, :-1]], axis=1)
    prod = iq * jnp.conj(prev)
    audio = jnp.arctan2(prod.imag, prod.real) / jnp.pi
    return audio.astype(jnp.float32), iq[:, -1]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DcBlockState:
    x1: jnp.ndarray  # [C] previous input
    y1: jnp.ndarray  # [C] previous output

    def tree_flatten(self):
        return (self.x1, self.y1), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def init(channels: int) -> "DcBlockState":
        return DcBlockState(
            jnp.zeros((channels,), jnp.float32),
            jnp.zeros((channels,), jnp.float32),
        )


@jax.jit
def dc_block(x: jnp.ndarray, state: DcBlockState, alpha: float = 0.999):
    """Single-pole DC blocker y[n] = x[n] - x[n-1] + a*y[n-1].

    The feedback makes this sequential, but it is a *linear* recurrence, so
    it runs as an associative scan (log-depth on device) instead of a
    per-sample loop: y[n] = sum_k a^(n-k) d[k] with d = diff(x).
    """
    d = x - jnp.concatenate([state.x1[:, None], x[:, :-1]], axis=1)

    def combine(a, b):
        # elements are (coeff, value): y = coeff*y_prev + value
        ca, va = a
        cb, vb = b
        return ca * cb, vb + cb * va

    coeffs = jnp.full_like(x, alpha)
    _, y = jax.lax.associative_scan(
        combine, (coeffs, d), axis=1
    )
    # fold in the carried y1: y[n] += a^(n+1) * y1
    n = jnp.arange(1, x.shape[1] + 1, dtype=jnp.float32)
    y = y + (alpha ** n)[None, :] * state.y1[:, None]
    return y, DcBlockState(x[:, -1], y[:, -1])
