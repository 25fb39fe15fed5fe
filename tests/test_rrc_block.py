"""The banded-matmul RRC block filter against the per-sample oracle."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.dsp.rrc import (NARROW_RRC, WIDE_RRC, RrcDesign, RrcState,
                                 rrc_filter_block, rrc_filter_np)


def _oracle(x, hist, design):
    """Run the oracle over [history | block]; outputs from the history's
    end on no longer see its zero-initialised delay line."""
    full = np.concatenate([hist, x], axis=1)
    return np.stack([rrc_filter_np(row, design)[hist.shape[1]:]
                     for row in full])


@pytest.mark.parametrize("design", [WIDE_RRC, NARROW_RRC])
@pytest.mark.parametrize("T", [700, 513, 4096])
def test_matmul_fir_matches_oracle(design, T):
    """Within the f32 envelope of the reference's sequential sum, and
    the carried history is the raw input tail."""
    rng = np.random.default_rng(5)
    C = 3
    x = rng.normal(0, 100, (C, T)).astype(np.float32)
    hist = rng.normal(0, 100, (C, design.ntaps - 1)).astype(np.float32)
    y, st = rrc_filter_block(jnp.asarray(x), RrcState(jnp.asarray(hist)),
                             design)
    want = _oracle(x, hist, design)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(y), want, atol=1e-5 * scale)
    np.testing.assert_array_equal(
        np.asarray(st.history),
        np.concatenate([hist, x], axis=1)[:, -(design.ntaps - 1):])


def test_matmul_fir_custom_design():
    """The banded matrix must key on the actual taps, not the design
    name — a custom RrcDesign (even one reusing a stock name, with
    asymmetric taps) gets its own matrix and the right orientation."""
    rng = np.random.default_rng(9)
    custom = RrcDesign("wide", 1.0, tuple(
        rng.normal(0, 0.3, 31).astype(np.float64)))
    C, T = 2, 400
    x = rng.normal(0, 10, (C, T)).astype(np.float32)
    hist = np.zeros((C, custom.ntaps - 1), np.float32)
    y, _ = rrc_filter_block(jnp.asarray(x), RrcState(jnp.asarray(hist)),
                            custom)
    np.testing.assert_allclose(np.asarray(y), _oracle(x, hist, custom),
                               atol=1e-4)


@pytest.mark.parametrize("T", [1, 127, 128, 129])
def test_non_multiple_block(T):
    """T not a multiple of the 128-sample group exercises the padding."""
    rng = np.random.default_rng(T)
    C = 2
    x = rng.normal(0, 1, (C, T)).astype(np.float32)
    hist = rng.normal(0, 1, (C, WIDE_RRC.ntaps - 1)).astype(np.float32)
    y, st = rrc_filter_block(jnp.asarray(x), RrcState(jnp.asarray(hist)),
                             WIDE_RRC)
    assert y.shape == (C, T)
    np.testing.assert_allclose(np.asarray(y), _oracle(x, hist, WIDE_RRC),
                               atol=1e-5)
    assert st.history.shape == (C, WIDE_RRC.ntaps - 1)
