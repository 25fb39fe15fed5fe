"""The batched Viterbi scan against the numpy reference oracle.

The trellis arithmetic is exact integers, so the contract is BIT-IDENTITY
— bits, metrics, and both reference tie-breaking rules (k=0 wins equal
metrics; lowest-numbered final state wins) on clean, noisy and
adversarially tie-heavy inputs, across batch sizes and shapes.
"""
import numpy as np
import pytest

from digiham_jax.fec.viterbi import (
    conv_encode,
    viterbi_decode,
    viterbi_decode_np,
)


def _compare(obs, blocked_steps=0, num_states=16):
    got_b, got_m = viterbi_decode(obs, num_states, blocked_steps)
    ref_b, ref_m = viterbi_decode_np(obs, num_states, blocked_steps)
    np.testing.assert_array_equal(np.asarray(got_b), ref_b)
    np.testing.assert_array_equal(np.asarray(got_m), ref_m)


@pytest.mark.parametrize("batch", [1, 5, 128, 129])
def test_clean_roundtrip(batch):
    rng = np.random.default_rng(batch)
    bits = rng.integers(0, 2, (batch, 100))
    obs = conv_encode(bits, 16)
    got_b, got_m = viterbi_decode(obs, 16, 0)
    np.testing.assert_array_equal(np.asarray(got_b), bits)
    assert np.all(np.asarray(got_m) == 0)


@pytest.mark.parametrize("seed", range(3))
def test_noisy_bitexact_vs_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    bits = rng.integers(0, 2, (37, 100))
    obs = conv_encode(bits, 16)
    flips = rng.random(obs.shape) < 0.12
    obs = np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs)
    _compare(obs)


def test_pure_noise_ties():
    """Uniform-random dibits maximize metric ties — the tie-breaking
    rules must match exactly."""
    rng = np.random.default_rng(7)
    _compare(rng.integers(0, 4, (64, 100)))
    # constant observations: every path equal — lowest state must win
    _compare(np.zeros((4, 48), np.int64))
    _compare(np.full((4, 48), 3, np.int64))


@pytest.mark.parametrize("seed", range(2))
def test_nxdn_blocked_start_states(seed):
    """blocked_steps=4 (NXDN SACCH/FACCH prior-knowledge window)."""
    rng = np.random.default_rng(200 + seed)
    bits = rng.integers(0, 2, (30, 30))
    bits[:, :4] = 0  # NXDN's known leading zeros
    obs = conv_encode(bits, 16)
    flips = rng.random(obs.shape) < 0.1
    obs = np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs)
    _compare(obs, blocked_steps=4)


def test_dstar_four_state_noisy():
    rng = np.random.default_rng(31)
    bits = rng.integers(0, 2, (9, 660))
    obs = conv_encode(bits, 4)
    flips = rng.random(obs.shape) < 0.08
    obs = np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs)
    _compare(obs, num_states=4)


def test_multidim_batch_shape():
    rng = np.random.default_rng(9)
    obs = rng.integers(0, 4, (3, 4, 60))
    got_b, got_m = viterbi_decode(obs, 16, 0)
    assert got_b.shape == (3, 4, 60) and got_m.shape == (3, 4)
    ref_b, ref_m = viterbi_decode_np(obs.reshape(12, 60), 16, 0)
    np.testing.assert_array_equal(np.asarray(got_b).reshape(12, 60), ref_b)
    np.testing.assert_array_equal(np.asarray(got_m).reshape(12), ref_m)


def test_shorter_than_blocked_window():
    """T < blocked_steps blocks only the first T steps."""
    rng = np.random.default_rng(77)
    for T in (1, 2, 3):
        _compare(rng.integers(0, 4, (5, T)), blocked_steps=4)
