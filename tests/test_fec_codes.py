"""Unit tests for the GF(2) block-code library.

Strategy mirrors the reference's offline syndrome generators
(src/dmr_decoder/golay_20_8_syndrome_generator.c etc.): enumerate error
patterns against known codewords and assert correction, plus spot-checks of
syndrome-table entries against values visible in the reference LUTs.
"""
import itertools

import numpy as np
import pytest

from digiham_jax.fec import ALL_CODES, decode, decode_np
from digiham_jax.fec import (
    BCH_31_21,
    GOLAY_20_8,
    GOLAY_24_12,
    HAMMING_7_4,
    HAMMING_16_11,
    QR_16_7,
)


def _random_codewords(code, count, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << code.k, size=count, dtype=np.int64)
    return code.encode(data)


@pytest.mark.parametrize("code", ALL_CODES, ids=lambda c: c.name)
def test_clean_codewords_decode_unchanged(code):
    words = _random_codewords(code, 64)
    out, ok = decode(code, words)
    np.testing.assert_array_equal(np.asarray(out), words)
    assert np.all(np.asarray(ok))


@pytest.mark.parametrize("code", ALL_CODES, ids=lambda c: c.name)
def test_all_correctable_error_patterns(code):
    """Every pattern within the enumeration depth is corrected exactly."""
    word = int(_random_codewords(code, 1, seed=7)[0])
    patterns = []
    for t in range(1, code.correct_bits + 1):
        for combo in itertools.combinations(range(code.n), t):
            patterns.append(sum(1 << b for b in combo))
    corrupted = np.asarray([word ^ p for p in patterns], dtype=np.int64)
    out, ok = decode(code, corrupted)
    out, ok = np.asarray(out), np.asarray(ok)
    # Codes whose tables contain ambiguous syndromes (entries the reference
    # marks "// incorrect result") may mis-correct beyond the guaranteed
    # radius; the guaranteed radius for each code family:
    guaranteed = {"golay_20_8": 3, "golay_24_12": 3, "qr_16_7": 2,
                  "bch_31_21": 2}.get(code.name, 1)
    for p, o, k in zip(patterns, out, ok):
        if bin(p).count("1") <= guaranteed:
            assert k, f"{code.name}: pattern {p:#x} not corrected"
            assert o == word, f"{code.name}: pattern {p:#x} miscorrected"


def test_jax_and_numpy_decoders_agree():
    rng = np.random.default_rng(3)
    for code in ALL_CODES:
        words = _random_codewords(code, 32, seed=11)
        noise = rng.integers(0, 1 << code.n, size=32, dtype=np.int64)
        corrupted = words ^ (noise & rng.integers(0, 1 << code.n, size=32))
        j_out, j_ok = decode(code, corrupted)
        n_out, n_ok = decode_np(code, corrupted)
        np.testing.assert_array_equal(np.asarray(j_out), n_out)
        np.testing.assert_array_equal(np.asarray(j_ok), n_ok)


# Spot checks against reference LUT entries (syndrome, error_pattern):
REFERENCE_LUT_SAMPLES = [
    # src/dmr_decoder/hamming_7_4.c:30-37
    (HAMMING_7_4, [(1, 1), (2, 2), (4, 4), (3, 8), (6, 16), (7, 32), (5, 64)]),
    # src/dmr_decoder/hamming_16_11.c:42-55
    (HAMMING_16_11, [(1, 1), (16, 16), (7, 32), (13, 64), (25, 128),
                     (22, 256), (11, 512), (21, 1024), (14, 2048), (28, 4096)]),
    # src/dmr_decoder/quadratic_residue.c:44-60
    (QR_16_7, [(1, 1), (3, 3), (114, 513), (228, 1025), (456, 2049),
               (483, 4097), (438, 8193), (287, 16385), (78, 32769)]),
    # src/dmr_decoder/golay_20_8.c:50-60
    (GOLAY_20_8, [(1, 1), (2, 2), (3, 3), (10, 10)]),
    # src/ysf_decoder/golay_24_12.c:55-60
    (GOLAY_24_12, [(1, 1), (2, 2), (3, 3), (4, 4)]),
    # src/pocsag_decoder/bch_31_21.c:21-29
    (BCH_31_21, [(1, 1), (2, 2), (3, 3), (5, 5), (6, 6), (9, 9)]),
]


@pytest.mark.parametrize(
    "code,samples", REFERENCE_LUT_SAMPLES, ids=lambda x: getattr(x, "name", "")
)
def test_syndrome_table_matches_reference_lut(code, samples):
    table = code.syndrome_table
    for syndrome, pattern in samples:
        assert table[syndrome] == pattern, (
            f"{code.name}: table[{syndrome}] = {table[syndrome]}, "
            f"reference has {pattern}"
        )


def test_table_sizes_match_reference_counts():
    """Distinct correctable syndromes must match the reference LUT entry
    counts (grep -c '{ [0-9]' over the reference .c files; the QR LUT lists
    ordered pairs so its 256 entries dedup to 136 distinct syndromes)."""
    assert int((GOLAY_20_8.syndrome_table >= 0).sum()) - 1 == 1350
    assert int((GOLAY_24_12.syndrome_table >= 0).sum()) - 1 == 2324
    assert int((QR_16_7.syndrome_table >= 0).sum()) - 1 == 136
    assert int((BCH_31_21.syndrome_table >= 0).sum()) - 1 == 496
