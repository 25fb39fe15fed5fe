"""Sync-pattern correlation as one exact convolution.

The reference scans one symbol at a time comparing a sync word
(hamming_distance LUT, src/lib/hamming_distance.c:3-12;
e.g. dmr_phase.cpp:39-47). The batched device form computes the
XOR-popcount distance of EVERY window offset against every pattern at
once. The original formulation was K (sync length) shifted
XOR-popcount-add passes per pattern (~96 HLO ops for DMR's
4 patterns); this module replaces it with a single convolution:

    dist[c, t, p] = sum_k popcount(sym[c, t+k] ^ pat[p, k])
                  = sum_k sum_v onehot(sym)[c, t+k, v] * W[k, v, p]

with static weights W[k, v, p] = popcount(v ^ pat[p, k]). XLA lowers
the conv to a matrix product (tensor cores on a GPU).

Exactness: every operand is a small non-negative integer (one-hot 0/1,
weights 0..2*bits_per_symbol, window sums <= 2*K <= 64), all exactly
representable even in bfloat16 or TF32, and the accumulation is f32 — so
the result is bit-exact vs the integer formulation at ANY matmul precision
(asserted in tests/test_correlate.py, and on the GPU by chip_smoke.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _weights(pat_bytes: bytes, P: int, K: int, n_values: int) -> np.ndarray:
    pats = np.frombuffer(pat_bytes, dtype=np.int64).reshape(P, K)
    W = np.zeros((K, n_values, P), np.float32)
    for p in range(P):
        for k in range(K):
            for v in range(n_values):
                W[k, v, p] = bin(v ^ int(pats[p, k])).count("1")
    return W


def sync_correlate_conv(symbols: jnp.ndarray, patterns,
                        n_values: int) -> jnp.ndarray:
    """symbols [..., T] integers in [0, n_values); patterns [P, K].

    Returns [..., T-K+1, P] int32 XOR-popcount distances.
    """
    pats = np.asarray(patterns, dtype=np.int64)
    P, K = pats.shape
    W = _weights(pats.tobytes(), P, K, n_values)
    onehot = (symbols[..., None] == jnp.arange(n_values)).astype(
        jnp.float32)
    lead = symbols.shape[:-1]
    T = symbols.shape[-1]
    out = jax.lax.conv_general_dilated(
        onehot.reshape((-1, T, n_values)),
        jnp.asarray(W),
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
    )
    return out.reshape(lead + out.shape[-2:]).astype(jnp.int32)
