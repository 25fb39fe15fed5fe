"""Tests for CRCs, LFSR keystreams, interleavers, Viterbi and BPTC."""
import numpy as np
import pytest

from digiham_jax.fec import crc as crc_mod
from digiham_jax.fec import lfsr
from digiham_jax.fec import interleave as il
from digiham_jax.fec import bptc
from digiham_jax.fec.viterbi import (
    conv_encode,
    viterbi_decode,
    viterbi_decode_np,
)


# ---------------------------------------------------------------- CRC


def _bits_msb(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def _bits_lsb(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little")


def test_crc16_ysf_known_vector():
    # CRC-16/XMODEM("123456789") = 0x31C3; the YSF variant adds xorout 0xFFFF
    bits = _bits_msb(b"123456789")
    crc = crc_mod.crc16_ysf(len(bits))
    assert int(crc.compute_np(bits)) == (0x31C3 ^ 0xFFFF)


def test_crc16_dstar_known_vector():
    # CRC-16/X-25("123456789") = 0x906E (reflected 0x8408, init/xorout 0xFFFF)
    bits = _bits_lsb(b"123456789")
    crc = crc_mod.crc16_dstar(len(bits))
    assert int(crc.compute_np(bits)) == 0x906E


def _simulate(step, init, bits, xor_out=0):
    reg = init
    for b in bits:
        reg = step(reg, int(b))
    return reg ^ xor_out


def test_affine_tables_match_direct_simulation():
    """The impulse-response tables must reproduce the direct bit-serial
    shift-register runs for random inputs (validates linearity + builder)."""
    rng = np.random.default_rng(0)

    def ysf_step(reg, bit):
        fb = bit ^ ((reg >> 15) & 1)
        reg = (reg << 1) & 0xFFFF
        return reg ^ (((1 << 12) | (1 << 5) | 1) if fb else 0)

    def dstar_step(reg, bit):
        fb = (reg ^ bit) & 1
        return (reg >> 1) ^ (0x8408 if fb else 0)

    def crc6_step(reg, bit):
        cb = ((reg >> 5) & 1) ^ bit
        if cb:
            reg ^= 0b00010011
        return ((reg << 1) & 0b00111110) | cb

    def crc12_step(reg, bit):
        cb = ((reg >> 11) & 1) ^ bit
        if cb:
            reg ^= 0b10000000111
        return ((reg << 1) & 0b111111111110) | cb

    cases = [
        (crc_mod.crc16_ysf(80), ysf_step, 0, 0xFFFF, 80),
        (crc_mod.crc16_dstar(80), dstar_step, 0xFFFF, 0xFFFF, 80),
        (crc_mod.crc6_nxdn(26), crc6_step, 0b111111, 0, 26),
        (crc_mod.crc12_nxdn(80), crc12_step, 0xFFF, 0, 80),
    ]
    for crc, step, init, xor_out, nbits in cases:
        batch = rng.integers(0, 2, size=(16, nbits))
        expect = np.array(
            [_simulate(step, init, row, xor_out) for row in batch]
        )
        np.testing.assert_array_equal(crc.compute_np(batch), expect)
        np.testing.assert_array_equal(np.asarray(crc.compute(batch)), expect)


# ---------------------------------------------------------------- LFSR


def test_ysf_whitening_keystream_prefix():
    """First bits from src/ysf_decoder/whitening.c semantics: wsr init
    0b111001001, output LSB, feedback bit4^bit0."""
    ks = lfsr.ysf_whitening(16)
    reg = 0b111001001
    expect = []
    for _ in range(16):
        wb = reg & 1
        expect.append(wb)
        wb2 = ((reg >> 4) & 1) ^ wb
        reg = ((reg & 0b111111110) >> 1) | (wb2 << 8)
    np.testing.assert_array_equal(ks, expect)


def test_dstar_scrambler_keystream_prefix():
    ks = lfsr.dstar_scrambler(16)
    reg = 0b1111111
    expect = []
    for _ in range(16):
        wb = (reg & 1) ^ ((reg >> 3) & 1)
        expect.append(wb)
        reg = ((reg & 0b1111110) >> 1) | (wb << 6)
    np.testing.assert_array_equal(ks, expect)


def test_nxdn_scrambler_dibits():
    dibits = np.arange(32) % 4
    out = lfsr.descramble_dibits_nxdn(dibits)
    reg = 0b011100100
    expect = []
    for d in dibits:
        wb = reg & 1
        expect.append((int(d) & 3) ^ (wb << 1))
        wb2 = ((reg >> 4) & 1) ^ wb
        reg = ((reg & 0b111111110) >> 1) | (wb2 << 8)
    np.testing.assert_array_equal(out, expect)


# ---------------------------------------------------------------- interleave


def test_tables_are_permutations():
    for tbl, n in [
        (il.bptc_196(), 196),
        (il.ysf_fich(), 100),
        (il.ysf_v2_voice(), 104),
        (il.nxdn_sacch(), 60),
        (il.nxdn_facch1(), 144),
        (il.dstar_header(), 660),
    ]:
        assert sorted(tbl.tolist()) == list(range(n))


def test_depuncture_shapes():
    idx, mask = il.depuncture_mask_sacch()
    assert mask.sum() == 60 and len(mask) == 72
    idx, mask = il.depuncture_mask_facch1()
    assert mask.sum() == 144 and len(mask) == 192
    out = il.depuncture(np.ones(60, dtype=np.int64), il.depuncture_mask_sacch())
    assert out.sum() == 60


# ---------------------------------------------------------------- viterbi


@pytest.mark.parametrize("num_states", [4, 16])
def test_viterbi_roundtrip_clean(num_states):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=(8, 96))
    dibits = conv_encode(bits, num_states)
    dec, metric = viterbi_decode(dibits, num_states)
    np.testing.assert_array_equal(np.asarray(dec), bits)
    assert np.all(np.asarray(metric) == 0)


@pytest.mark.parametrize("num_states", [4, 16])
def test_viterbi_corrects_sparse_errors(num_states):
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, size=(8, 96))
    dibits = conv_encode(bits, num_states)
    noisy = dibits.copy()
    # flip one transmitted symbol every ~25 symbols (well within capability).
    # Keep errors away from the first steps: like the reference, the decoder
    # starts with all-zero path metrics (no anchored start state), so errors
    # in the very first symbols are genuinely ambiguous.
    for r in range(noisy.shape[0]):
        for pos in range(12, 84, 25):
            noisy[r, pos] ^= rng.integers(1, 4)
    dec, metric = viterbi_decode(noisy, num_states)
    np.testing.assert_array_equal(np.asarray(dec), bits)
    assert np.all(np.asarray(metric) > 0)


@pytest.mark.parametrize("num_states,blocked", [(4, 0), (16, 0), (16, 4)])
def test_viterbi_jax_matches_numpy_on_noise(num_states, blocked):
    """Tie-break equivalence on random garbage input."""
    rng = np.random.default_rng(3)
    obs = rng.integers(0, 4, size=(16, 60))
    jb, jm = viterbi_decode(obs, num_states, blocked)
    nb, nm = viterbi_decode_np(obs, num_states, blocked)
    np.testing.assert_array_equal(np.asarray(jb), nb)
    np.testing.assert_array_equal(np.asarray(jm), nm)


def test_viterbi_blocked_start_uses_prior():
    """NXDN prior: data starts with 4 zero bits; corrupt the first dibits
    heavily — the blocked decoder must still start from the zero state."""
    rng = np.random.default_rng(4)
    bits = np.zeros((4, 40), dtype=np.int64)
    bits[:, 4:] = rng.integers(0, 2, size=(4, 36))
    dibits = conv_encode(bits, 16)
    noisy = dibits.copy()
    noisy[:, 0] ^= 3  # destroy the first symbol completely
    dec, _ = viterbi_decode(noisy, 16, blocked_steps=4)
    np.testing.assert_array_equal(np.asarray(dec)[:, :4], 0)


# ---------------------------------------------------------------- bptc


def test_bptc_roundtrip_and_correction():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2, size=(8, 96))
    tx = bptc.encode(data)
    rx_bits, ok = bptc.decode(tx)
    assert np.all(np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(rx_bits), data)

    # single bit errors anywhere must be corrected
    tx_err = tx.copy()
    for r in range(tx.shape[0]):
        tx_err[r, rng.integers(0, 196)] ^= 1
    rx_bits, ok = bptc.decode(tx_err)
    assert np.all(np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(rx_bits), data)

    # numpy variant agrees
    nb, nok = bptc.decode_np(tx_err)
    np.testing.assert_array_equal(np.asarray(rx_bits), nb)
    np.testing.assert_array_equal(np.asarray(ok), nok)
