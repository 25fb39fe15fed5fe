"""Exactness of the conv-based sync correlation vs the integer form."""
import numpy as np

import jax
import jax.numpy as jnp

from digiham_jax.ops.correlate import sync_correlate_conv


def _reference(symbols, patterns, n_values):
    """Integer shifted-XOR-popcount formulation (the pre-conv device
    implementation and the literal semantics of the reference's
    per-offset hamming_distance scan)."""
    d = np.asarray(symbols, dtype=np.int64)
    pats = np.asarray(patterns, dtype=np.int64)
    P, K = pats.shape
    n_off = d.shape[-1] - K + 1
    out = np.zeros(d.shape[:-1] + (n_off, P), np.int32)
    for p in range(P):
        for k in range(K):
            x = d[..., k:k + n_off] ^ pats[p, k]
            out[..., p] += np.vectorize(lambda v: bin(v).count("1"))(x)
    return out


def test_dibit_patterns_exact():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 4, (5, 300))
    pats = rng.integers(0, 4, (4, 24))
    got = np.asarray(sync_correlate_conv(jnp.asarray(d), pats, 4))
    np.testing.assert_array_equal(got, _reference(d, pats, 4))


def test_bit_pattern_exact():
    rng = np.random.default_rng(1)
    b = rng.integers(0, 2, (3, 200))
    pat = rng.integers(0, 2, (1, 32))
    got = np.asarray(sync_correlate_conv(jnp.asarray(b), pat, 2))
    np.testing.assert_array_equal(got, _reference(b, pat, 2))


def test_exact_at_default_and_highest_precision():
    """All conv operands are small integers exactly representable in
    bf16, so the result must be identical at any matmul precision."""
    rng = np.random.default_rng(2)
    d = jnp.asarray(rng.integers(0, 4, (4, 400)))
    pats = rng.integers(0, 4, (2, 20))
    with jax.default_matmul_precision("bfloat16"):
        lo = np.asarray(sync_correlate_conv(d, pats, 4))
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(sync_correlate_conv(d, pats, 4))
    np.testing.assert_array_equal(lo, hi)
