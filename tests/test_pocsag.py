"""POCSAG end-to-end: synthesize codeword bit streams, decode, verify text."""
import numpy as np
import pytest

import jax.numpy as jnp

from digiham_jax.fec.codes import BCH_31_21
from digiham_jax.protocols import pocsag
from digiham_jax.protocols.pocsag import (
    CODEWORDS_PER_SYNC,
    IDLE_CODEWORD,
    SYNC_PATTERN,
    Message,
    make_decoder,
    parse_codewords,
    sync_distances,
)
from digiham_jax.runtime.decoder import Output
from digiham_jax.runtime.meta import StringSerializer


def u32_bits(word):
    return np.array([(word >> (31 - i)) & 1 for i in range(32)], np.uint8)


def make_codeword(info21: int) -> int:
    """info21 -> 32-bit codeword: BCH(31,21) + even parity bit (LSB)."""
    word31 = int(BCH_31_21.encode(info21))
    parity = bin(word31).count("1") & 1
    return (word31 << 1) | parity


def address_codeword(address18: int, func: int) -> int:
    return make_codeword((0 << 20) | (address18 << 2) | func)


def data_codeword(payload20: int) -> int:
    return make_codeword((1 << 20) | payload20)


def alpha_payloads(text: str):
    """Pack text into 20-bit payloads: 7-bit chars, LSB-first per char,
    then read 20 bits MSB-first per codeword (inverse of message.cpp:29-35)."""
    bits = []
    for ch in text:
        c = ord(ch)
        bits.extend((c >> k) & 1 for k in range(7))
    while len(bits) % 20:
        bits.append(0)
    out = []
    for i in range(0, len(bits), 20):
        word = 0
        for j in range(20):
            word |= bits[i + j] << (19 - j)
        out.append(word)
    return out


def build_stream(codewords, preamble_bits=96):
    """Alternating preamble + sync + 16-codeword batches."""
    bits = [np.tile(np.array([1, 0], np.uint8), preamble_bits // 2)]
    for i in range(0, len(codewords), CODEWORDS_PER_SYNC):
        batch = codewords[i:i + CODEWORDS_PER_SYNC]
        batch = batch + [IDLE_CODEWORD] * (CODEWORDS_PER_SYNC - len(batch))
        bits.append(SYNC_PATTERN)
        for cw in batch:
            bits.append(u32_bits(cw))
    # trailing sync + idles so the decoder's re-sync check passes
    bits.append(SYNC_PATTERN)
    for _ in range(CODEWORDS_PER_SYNC):
        bits.append(u32_bits(IDLE_CODEWORD))
    return np.concatenate(bits)


class TestCodeword:
    def test_roundtrip_and_correction(self):
        rng = np.random.default_rng(0)
        words = np.array([address_codeword(int(a), 3)
                          for a in rng.integers(0, 1 << 18, 50)])
        got, ok = parse_codewords(jnp.asarray(words))
        assert np.all(np.asarray(ok))
        np.testing.assert_array_equal(np.asarray(got), words)

        # flip up to 2 bits in the BCH-protected span (bits 1..31)
        corrupted = words.copy()
        for i in range(len(words)):
            for b in rng.choice(31, size=rng.integers(1, 3), replace=False):
                corrupted[i] ^= 1 << (int(b) + 1)
        got, ok = parse_codewords(jnp.asarray(corrupted))
        # parity may flag odd-weight errors unless the corrected word
        # restores it; after BCH correction parity must hold again
        assert np.all(np.asarray(ok))
        np.testing.assert_array_equal(np.asarray(got), words)

    def test_three_bit_errors_rejected_or_wrong(self):
        w = address_codeword(12345, 1)
        bad = w ^ 0b10110010  # 4 flipped bits
        got, ok = parse_codewords(jnp.asarray([bad]))
        # must not silently return the original word
        assert (not bool(np.asarray(ok)[0])) or np.asarray(got)[0] != w


class TestSyncSearch:
    def test_dense_distances(self):
        bits = np.zeros(300, np.uint8)
        bits[100:132] = SYNC_PATTERN
        d = np.asarray(sync_distances(jnp.asarray(bits)[None, :]))[0]
        assert d[100] == 0
        assert d.min() == 0 and d.argmin() == 100

    def test_tolerates_3_errors(self):
        bits = np.zeros(200, np.uint8)
        pat = SYNC_PATTERN.copy()
        pat[[3, 10, 25]] ^= 1
        bits[50:82] = pat
        d = np.asarray(sync_distances(jnp.asarray(bits)[None, :]))[0]
        assert d[50] == 3


class TestEndToEnd:
    def test_alpha_message(self):
        text = "HELLO BANK WORLD"
        addr = 0x1234
        frame_pos = 2
        cws = [IDLE_CODEWORD] * (frame_pos * 2)
        cws.append(address_codeword(addr, 3))
        cws.extend(data_codeword(p) for p in alpha_payloads(text))
        cws.append(IDLE_CODEWORD)
        stream = build_stream(cws)
        dec = make_decoder()
        out = dec.process(stream).decode()
        assert f"address:{(addr << 3) | frame_pos}" in out
        assert f"message:{text}" in out

    def test_numeric_message_class(self):
        """The BCD append path (message.cpp:37-68). NOTE reference
        behavior parity: the phase gate only opens messages for function
        bits 1/3 (pocsag_phase.cpp:66), but append() only fills content
        for types 0/3 — so a type-0 Message is only reachable through the
        class API, and function-bit-0 address codewords never produce
        output end to end."""
        def bcd_payload(digits):
            word = 0
            for i, d in enumerate(digits):
                rev = int(f"{d:04b}"[::-1], 2)
                word |= rev << ((4 - i) * 4)
            return word

        msg = Message(42, 0)
        msg.append(bcd_payload([1, 2, 3, 4, 5]))
        msg.append(bcd_payload([6, 7, 8, 9, 0]))
        out = Output()
        msg.serialize(StringSerializer(), out)
        assert out.drain() == b"address:42;message:1234567890\n"

    def test_function_bit_0_no_output(self):
        """Reference parity: function bits 0 opens no message."""
        cws = [address_codeword(0x3FF00, 0),
               data_codeword(0xABCDE),
               IDLE_CODEWORD]
        out = make_decoder().process(build_stream(cws))
        assert out == b""

    def test_message_with_bit_errors(self):
        text = "PAGER42"
        cws = [address_codeword(77, 3)]
        cws.extend(data_codeword(p) for p in alpha_payloads(text))
        cws.append(IDLE_CODEWORD)
        stream = build_stream(cws)
        rng = np.random.default_rng(3)
        # flip one random bit inside every codeword region
        start = 96 + 32  # preamble + first sync
        for k in range(len(cws)):
            pos = start + 32 * k + int(rng.integers(1, 31))
            stream[pos] ^= 1
        out = make_decoder().process(stream).decode()
        assert f"message:{text}" in out

    def test_streaming_chunks_equal_oneshot(self):
        text = "CHUNKED MSG"
        cws = [address_codeword(999, 3)]
        cws.extend(data_codeword(p) for p in alpha_payloads(text))
        cws.append(IDLE_CODEWORD)
        stream = build_stream(cws)
        whole = make_decoder().process(stream)
        dec = make_decoder()
        chunks = b"".join(dec.process(stream[i:i + 57])
                          for i in range(0, len(stream), 57))
        assert whole == chunks
        assert text.encode() in whole

    def test_garbage_no_output(self):
        rng = np.random.default_rng(4)
        # random bits: every sync match is coincidence; decoder must not
        # emit anything parseable and must not crash
        bits = rng.integers(0, 2, 20000).astype(np.uint8)
        out = make_decoder().process(bits)
        assert b"message:" not in out or len(out) < 200


def numeric_payloads(digits: str):
    """Pack a digit string into 20-bit payloads: 5 reversed-BCD nibbles
    per codeword (inverse of message.cpp:46-60 / protocols.pocsag
    Message.append type 0)."""
    rev = {v: k for k, v in
           {0xA: "*", 0xB: "U", 0xC: " ", 0xD: "-", 0xE: ")",
            0xF: "("}.items()}
    out = []
    for lo in range(0, len(digits), 5):
        chunk = digits[lo:lo + 5].ljust(5, " ")
        word = 0
        for i, ch in enumerate(chunk):
            nib = int(ch) if ch.isdigit() else rev[ch]
            base = (4 - i) * 4
            for k in range(4):
                word |= ((nib >> (3 - k)) & 1) << (base + k)
        out.append(word)
    return out


class TestNumericPath:
    """The reference never opens numeric (fn=0) messages
    (pocsag_phase.cpp:70) — reproduced by default. Exercise the type-0
    BCD decoder end-to-end behind the OPEN_FUNCTION_BITS test switch so
    the dead path cannot rot."""

    def test_numeric_message_end_to_end(self, monkeypatch):
        from digiham_jax.protocols import pocsag as pmod

        digits = "0123456789*U -)("
        cws = [address_codeword(321, 0)]
        cws += [data_codeword(p) for p in numeric_payloads(digits)]
        cws.append(IDLE_CODEWORD)
        bits = build_stream(cws).astype(np.uint8)

        monkeypatch.setattr(pmod, "OPEN_FUNCTION_BITS", (0, 1, 3))
        out = pmod.make_decoder().process(bits)
        assert b"address:2568" in out  # (321<<3) | frame position 0
        assert f"message:{digits}".encode().rstrip() in out

    def test_numeric_closed_by_default(self):
        from digiham_jax.protocols import pocsag as pmod
        digits = "5551234"
        cws = [address_codeword(321, 0)]
        cws += [data_codeword(p) for p in numeric_payloads(digits)]
        cws.append(IDLE_CODEWORD)
        bits = build_stream(cws).astype(np.uint8)
        out = pmod.make_decoder().process(bits)
        assert b"message:" not in out  # reference dead path reproduced
